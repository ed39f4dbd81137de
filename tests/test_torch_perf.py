"""The port's perf models (``repro_torch.perf.{flops, hardware, hlo,
roofline}``) against the JAX package's.

Tolerances: bit equality throughout. The port copies the reference's
arithmetic (FLOP counts in Python floats over the same configs, regex over
the same HLO text, the same roofline terms), so ``cell_flops`` for every
config and shape, the collective inventories and a report's ``to_json()`` at
the reference's default spec agree exactly. One divergence is on purpose
(ROADMAP C12): the reference's ``roofline_fraction`` divides by the TPU v5e's
peak whatever spec built the report; the port divides by that spec's. At
``H100_SXM`` the port's fraction is therefore the reference's x 197 / 989.
"""

import json
from dataclasses import asdict

import pytest

import repro.configs as ref_cfgs
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.perf import flops as ref_flops
from repro.perf import hardware as ref_hw
from repro.perf import hlo as ref_hlo
from repro.perf import roofline as ref_roof
import repro_torch.perf as port_perf
from repro_torch import configs as port_cfgs
from repro_torch.perf import flops as port_flops
from repro_torch.perf import hardware as port_hw
from repro_torch.perf import hlo as port_hlo
from repro_torch.perf import roofline as port_roof


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_flops_bit_equal(arch, shape):
    a = ref_flops.cell_flops(get_config(arch), SHAPES[shape])
    b = port_flops.cell_flops(port_cfgs.get_config(arch), port_cfgs.SHAPES[shape])
    assert asdict(a) == asdict(b)
    assert a.total > 0


def test_hardware_constants():
    for name in ("TPU_V5E", "DEVICE_TIER_V5E_1", "CLIENT_NPU"):
        assert asdict(getattr(ref_hw, name)) == asdict(getattr(port_hw, name))
    h = port_hw.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes, h.ici_bw) == (989e12, 3.35e12, 80e9, 450e9)
    exported = {n for m in (port_flops, port_hw, port_hlo, port_roof) for n in m.__all__}
    assert set(port_perf.__all__) == exported
    reference = {n for m in (ref_flops, ref_hw, ref_hlo, ref_roof) for n in m.__all__}
    assert exported - reference == {"H100_SXM"}


# the two HLO texts of tests/test_system.py
HLO_TEXTS = {
    "synthetic": """
  %ar = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %add), replica_groups={}
  %ag = bf16[16,256]{1,0} all-gather(bf16[2,256]{1,0} %slice), dimensions={0}
  %rs = f32[2,64]{1,0} reduce-scatter(f32[16,64]{1,0} %x), dimensions={0}
  %a2a = f32[4,32]{1,0} all-to-all(f32[4,32]{1,0} %y), dimensions={0}
  %cp = f32[4]{0} collective-permute(f32[4]{0} %z), source_target_pairs={{0,1}}
""",
    "async_pair": """
  %s = f32[8]{0} all-gather-start(f32[2]{0} %x), dimensions={0}
  %d = f32[8]{0} all-gather-done(f32[8]{0} %s)
""",
}


@pytest.mark.parametrize("name", sorted(HLO_TEXTS))
def test_parse_collectives_equal(name):
    a, b = ref_hlo.parse_collectives(HLO_TEXTS[name]), port_hlo.parse_collectives(HLO_TEXTS[name])
    assert a.summary() == b.summary() and a.summary()["counts"]
    assert (a.total_operand_bytes, a.total_output_bytes) == (b.total_operand_bytes,
                                                             b.total_output_bytes)
    assert (a + a).summary() == (b + b).summary()
    assert a.scaled(2.5).summary() == b.scaled(2.5).summary()
    assert ref_hlo.DTYPE_BYTES == port_hlo.DTYPE_BYTES


def counts_cases():
    """(name, kwargs maker) for report_from_counts: with and without a
    config, collectives as stats or as a dict, supplements, notes."""
    text = HLO_TEXTS["synthetic"]
    return {
        "decode_cfg_stats": lambda hlo, cfgs: dict(
            arch="starcoder2_3b", shape=cfgs.SHAPES["decode_32k"], mesh_name="1x1", n_chips=1,
            flops_per_dev=2.1e12, bytes_per_dev=6.4e9, collectives=hlo.parse_collectives(text),
            cfg=cfgs.get_config("starcoder2_3b")),
        "train_dict_supplement": lambda hlo, cfgs: dict(
            arch="jamba_v0_1_52b", shape=cfgs.SHAPES["train_4k"], mesh_name="4x4", n_chips=16,
            flops_per_dev=3.3e15, bytes_per_dev=2.2e12,
            collectives={"wire_bytes": 1.5e11, "counts": {"all-reduce": 12}},
            cfg=cfgs.get_config("jamba_v0_1_52b"), supplement_flops_global=4.0e15,
            memory_analysis={"temp": 1.0}, notes="supplemented"),
        "no_cfg_string_shape": lambda hlo, cfgs: dict(
            arch="x", shape="custom", mesh_name="1", n_chips=2, flops_per_dev=0.0,
            bytes_per_dev=0.0, collectives={}),
    }


@pytest.mark.parametrize("case", sorted(counts_cases()))
def test_report_from_counts_to_json_equal_at_the_default_spec(case):
    make = counts_cases()[case]
    for explicit in (False, True):  # the default spec, then TPU_V5E passed as hw
        a = ref_roof.report_from_counts(**make(ref_hlo, ref_cfgs),
                                        **({"hw": ref_hw.TPU_V5E} if explicit else {}))
        b = port_roof.report_from_counts(**make(port_hlo, port_cfgs),
                                         **({"hw": port_hw.TPU_V5E} if explicit else {}))
        assert a.to_json() == b.to_json()
        assert (a.bound_s, a.roofline_fraction, a.dominant) == (b.bound_s, b.roofline_fraction,
                                                                b.dominant)


def test_roofline_fraction_divides_by_the_report_spec_c12():
    """C12: at H100_SXM the reference divides the useful FLOPs by the v5e's
    197 TFLOP/s, so a compute-bound step whose FLOPs are all useful reads 5x
    its roofline; the port reads 1."""
    cfg_r, cfg_p = get_config("starcoder2_3b"), port_cfgs.get_config("starcoder2_3b")
    shape = "prefill_32k"
    useful = ref_flops.cell_flops(cfg_r, SHAPES[shape]).total
    kw = dict(arch="starcoder2_3b", mesh_name="1", n_chips=1, flops_per_dev=useful,
              bytes_per_dev=1.0, collectives={})
    a = ref_roof.report_from_counts(shape=SHAPES[shape], cfg=cfg_r,
                                    hw=ref_hw.HardwareSpec(**asdict(port_hw.H100_SXM)), **kw)
    b = port_roof.report_from_counts(shape=port_cfgs.SHAPES[shape], cfg=cfg_p,
                                     hw=port_hw.H100_SXM, **kw)
    assert (a.compute_s, a.memory_s, a.bound_s) == (b.compute_s, b.memory_s, b.bound_s)
    assert b.roofline_fraction == pytest.approx(1.0, rel=1e-12)
    assert a.roofline_fraction > 5.0
    assert b.roofline_fraction == pytest.approx(a.roofline_fraction * 197 / 989, rel=1e-12)
    # every key of to_json but the fraction agrees; the spec itself stays out
    ja, jb = json.loads(a.to_json()), json.loads(b.to_json())
    assert ja.pop("roofline_fraction") != jb.pop("roofline_fraction") and ja == jb
    assert "hw" not in jb and "hw" not in repr(b)


def test_combine_linear_equal():
    samples = {(1, 1): {"flops": 10.0, "bytes": 4.0}, (2, 1): {"flops": 17.0, "bytes": 6.5},
               (1, 2): {"flops": 12.0, "bytes": 4.25}}
    for full in ((1, 1), (5, 1), (5, 24), (3, 7)):
        assert ref_roof.combine_linear(samples, full) == port_roof.combine_linear(samples, full)
    one = {(1,): {"flops": 3.0}}
    assert ref_roof.combine_linear(one, (1,)) == port_roof.combine_linear(one, (1,))
    for lib in (ref_roof, port_roof):
        with pytest.raises(KeyError, match="missing probe"):
            lib.combine_linear(one, (4,))
