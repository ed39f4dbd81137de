"""The port's optimizers, gradient compression, checkpointer, trainer and
data pipeline: the twin of ``tests/test_training.py``, on the CPU, plus the
pipeline's statistics against the reference's and ``launch.train`` run with
``jax`` blocked.

The pipeline cannot replay ``jax.random``, so it is held to the reference
in distribution: over 64 rows of 512 tokens from each package, the share of
the three most frequent Zipf ids among the non-motif rows within 0.02 of
the reference's (shares of 0.25, 0.11 and 0.07 over ~16k tokens: binomial
standard errors of at most 0.004), the motif rows' share within 0.15 of 0.5 (64
Bernoulli rows: sd 0.0625), and the prefix embeddings' std within 5% of
0.02 (tens of thousands of normal draws).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro_torch.checkpoint.checkpointer import Checkpointer, load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_batch
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parent.parent


class TestAdamW:
    def test_converges_on_quadratic(self):
        params = {"w": torch.tensor([4.0, -3.0])}
        state = opt.adamw_init(params)
        cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0)
        for _ in range(150):
            grads = {"w": 2 * params["w"]}
            params, state, _ = opt.adamw_update(cfg, grads, state, params)
        assert float(params["w"].abs().max()) < 1e-2

    def test_master_is_a_copy_and_params_keep_their_dtype(self):
        params = {"w": torch.ones(4, dtype=torch.bfloat16), "b": torch.ones(2)}
        state = opt.adamw_init(params)
        assert state["master"]["b"] is not params["b"]
        assert state["master"]["w"].dtype == torch.float32
        new, state, m = opt.adamw_update(opt.AdamWConfig(lr=0.1), {k: torch.ones_like(p) for k, p
                                                                   in params.items()}, state,
                                         params)
        assert new["w"].dtype == torch.bfloat16 and new["b"].dtype == torch.float32
        assert int(state["count"]) == 1 and float(params["b"][0]) == 1.0

    def test_clip_by_global_norm(self):
        grads = {"a": torch.tensor([3.0, 4.0])}  # norm 5
        clipped, gn = opt.clip_by_global_norm(grads, 1.0)
        assert float(gn) == pytest.approx(5.0)
        assert float(clipped["a"].norm()) == pytest.approx(1.0)

    def test_cosine_schedule(self):
        lr = opt.cosine_schedule(1.0, warmup=10, total=100)
        assert float(lr(0)) == pytest.approx(0.0)
        assert float(lr(10)) == pytest.approx(1.0)
        assert float(lr(100)) == pytest.approx(0.1, rel=0.01)

    def test_abstract_state_shapes(self):
        spec = opt.abstract_adamw_state({"w": ((3, 5), torch.bfloat16)})
        assert spec["master"]["w"] == ((3, 5), torch.float32) == spec["v"]["w"]
        assert spec["count"] == ((), torch.int32)


class TestAdafactor:
    def test_converges_on_quadratic(self):
        params = {"w": torch.full((256, 256), 2.0)}  # factored leaf
        state = opt.adafactor_init(params)
        cfg = opt.AdafactorConfig(lr=0.3)
        for _ in range(120):
            grads = {"w": 2 * params["w"]}
            params, state, _ = opt.adafactor_update(cfg, grads, state, params)
        assert float(params["w"].abs().mean()) < 0.05

    def test_state_is_factored(self):
        params = {"big": torch.zeros((256, 512)), "small": torch.zeros((8,))}
        state = opt.adafactor_init(params)
        assert state["factors"]["big"]["vr"].shape == (256,)
        assert state["factors"]["big"]["vc"].shape == (512,)
        assert state["factors"]["small"]["v"].shape == (8,)
        spec = opt.abstract_adafactor_state({k: (tuple(p.shape), p.dtype) for k, p in
                                             params.items()})
        assert spec["factors"]["big"] == {"vr": ((256,), torch.float32),
                                          "vc": ((512,), torch.float32)}

    def test_memory_footprint_tiny_vs_adamw(self):
        params = {"w": torch.zeros((1024, 1024), dtype=torch.bfloat16)}

        def nbytes(tree):
            if isinstance(tree, dict):
                return sum(nbytes(v) for v in tree.values())
            return tree.numel() * tree.element_size()

        assert nbytes(opt.adafactor_init(params)) < nbytes(opt.adamw_init(params)) / 100

    def test_groups_pool_the_rms_statistics(self):
        """Two leaves of one group move as the reference's stacked leaf does:
        the same as one tensor holding both."""
        g = torch.Generator().manual_seed(0)
        a, b = torch.randn(8, generator=g), torch.randn(8, generator=g) * 3
        ga, gb = torch.randn(8, generator=g), torch.randn(8, generator=g)
        cfg = opt.AdafactorConfig(lr=0.1)
        split = {"a": a, "b": b}
        new, _, _ = opt.adafactor_update(cfg, {"a": ga, "b": gb}, opt.adafactor_init(split),
                                         split, groups={"a": "s", "b": "s"})
        one = {"s": torch.stack([a, b])}
        want, _, _ = opt.adafactor_update(cfg, {"s": torch.stack([ga, gb])},
                                          opt.adafactor_init(one), one)
        torch.testing.assert_close(torch.stack([new["a"], new["b"]]), want["s"], rtol=1e-6,
                                   atol=1e-7)


class TestGradCompression:
    def test_roundtrip_error_bounded(self):
        g = {"w": torch.randn(512, generator=torch.Generator().manual_seed(0))}
        q, scales, err = opt.compress_grads(g, None)
        deq = opt.decompress_grads(q, scales)
        assert float((deq["w"] - g["w"]).norm() / g["w"].norm()) < 0.02  # int8 noise
        assert q["w"].dtype == torch.int8

    def test_error_feedback_accumulates(self):
        """EF: repeated compression of a constant gradient must average out:
        the residual makes the quantised sum track the true sum."""
        g = {"w": torch.full((64,), 0.001)}
        err, total = None, torch.zeros(64)
        for _ in range(100):
            q, s, err = opt.compress_grads(g, err)
            total = total + opt.decompress_grads(q, s)["w"]
        np.testing.assert_allclose(total.numpy(), 0.1 * np.ones(64), rtol=0.05)

    def test_compressed_training_converges(self):
        params = {"w": torch.tensor([4.0, -3.0])}
        state = opt.adamw_init(params)
        cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, compress=True)
        err = None
        for _ in range(150):
            q, s, err = opt.compress_grads({"w": 2 * params["w"]}, err)
            params, state, _ = opt.adamw_update(cfg, opt.decompress_grads(q, s), state, params)
        assert float(params["w"].abs().max()) < 5e-2

    def test_groups_share_one_scale(self):
        g = {"a": torch.tensor([1.0, -0.5]), "b": torch.tensor([0.25, 4.0])}
        _, scales, _ = opt.compress_grads(g, None, groups={"a": "s", "b": "s"})
        assert float(scales["a"]) == float(scales["b"]) == pytest.approx(4.0 / 127)


class TestCheckpointer:
    def test_roundtrip_structure(self, tmp_path):
        tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                "b": (torch.zeros(3), [torch.tensor(4, dtype=torch.int32), None]),
                "c": {"count": torch.zeros((), dtype=torch.int32)}}
        p = tmp_path / "x.ckpt"
        save_pytree(p, tree)
        back = load_pytree(p, device="cpu")
        assert back["a"].dtype == torch.bfloat16 and torch.equal(back["a"], tree["a"])
        assert isinstance(back["b"], tuple) and isinstance(back["b"][1], list)
        assert back["b"][1][1] is None and int(back["b"][1][0]) == 4

    def test_restore_with_target_dtypes(self, tmp_path):
        p = tmp_path / "x.ckpt"
        save_pytree(p, {"w": torch.ones((4, 4))})
        back = load_pytree(p, device="cpu", target={"w": ((4, 4), torch.bfloat16)})
        assert back["w"].dtype == torch.bfloat16
        with pytest.raises(ValueError, match="target"):
            load_pytree(p, device="cpu", target={"w": ((4, 5), torch.bfloat16)})

    def test_retention_and_latest(self, tmp_path):
        ck = Checkpointer(tmp_path, keep=2)
        for s in (10, 20, 30):
            ck.save(s, {"x": torch.tensor(s)})
        assert ck.steps() == [20, 30] and ck.latest_step() == 30
        step, tree = ck.restore(device="cpu")
        assert step == 30 and int(tree["x"]) == 30

    def test_no_tmp_residue(self, tmp_path):
        ck = Checkpointer(tmp_path)
        ck.save(1, {"x": torch.zeros(4)})
        assert [f.name for f in tmp_path.iterdir()] == ["step_0000000001.ckpt"]


class TestTrainerResume:
    def test_bit_exact_resume(self, tmp_path):
        cfg = get_config("starcoder2_3b").reduced()
        tc = TrainConfig(steps=6, batch=2, seq_len=32, checkpoint_every=3,
                         checkpoint_dir=str(tmp_path), log_every=1, lr=1e-3)
        model, state, log = Trainer(cfg, tc, device="cpu").run()
        assert Checkpointer(tmp_path).steps() == [3, 6]
        t2 = Trainer(cfg, tc, device="cpu")
        resumed, rstate, step = t2.resume(3)
        assert step == 3 and int(rstate["count"]) == 3
        resumed, rstate, rlog = t2.run(resumed, rstate, start_step=step)
        assert [r["loss"] for r in rlog] == [r["loss"] for r in log[3:]]
        for a, b in zip(model.parameters(), resumed.parameters()):
            assert torch.equal(a, b)
        for a, b in zip(state["v"].values(), rstate["v"].values()):
            assert torch.equal(a, b)

    def test_latest_resume_and_adafactor_state(self, tmp_path):
        cfg = get_config("dbrx_132b").reduced()
        tc = TrainConfig(steps=2, batch=2, seq_len=16, checkpoint_dir=str(tmp_path), lr=1e-3)
        t = Trainer(cfg, tc, device="cpu")
        assert isinstance(t.ocfg, opt.AdafactorConfig)
        _, state, _ = t.run()
        _, restored, step = Trainer(cfg, tc, device="cpu").resume()
        assert step == 2 and set(restored["factors"]) == set(state["factors"])

    def test_straggler_watchdog_records(self):
        cfg = get_config("starcoder2_3b").reduced()
        tc = TrainConfig(steps=10, batch=2, seq_len=16, deadline_factor=0.0, log_every=1)
        t = Trainer(cfg, tc, device="cpu")
        t.run()
        # with a zero deadline every step from the eighth on is a straggler
        assert [e["step"] for e in t.straggler_events] == [7, 8, 9]
        assert len(t.metrics_log) == 10 and all(r["step_time_s"] > 0 for r in t.metrics_log)

    def test_no_checkpoint_dir_refuses_resume(self):
        t = Trainer(get_config("starcoder2_3b").reduced(), TrainConfig(steps=1), device="cpu")
        with pytest.raises(ValueError, match="checkpoint"):
            t.resume()


class TestPipeline:
    def test_stateless_resume(self):
        cfg = get_config("starcoder2_3b").reduced()
        src = SyntheticLM(cfg, DataConfig(batch=2, seq_len=16, seed=3), device="cpu")
        a, b, c = src[5], src[5], src[6]
        assert torch.equal(a["tokens"], b["tokens"])
        assert not torch.equal(a["tokens"], c["tokens"])
        again = SyntheticLM(cfg, DataConfig(batch=2, seq_len=16, seed=3), device="cpu")[5]
        assert torch.equal(a["tokens"], again["tokens"])

    @pytest.mark.parametrize("arch", ["starcoder2_3b", "internvl2_1b", "seamless_m4t_large_v2"])
    def test_batch_layout_matches_the_reference(self, arch):
        """The same keys, shapes and dtypes as the reference's batch; targets
        the tokens rolled by -1, the mask 0 at the last position only."""
        jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        want = JaxSyntheticLM(jcfg, JaxDataConfig(batch=2, seq_len=32))[0]
        got = make_batch(cfg, 2, 32, device="cpu")
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == tuple(want[k].shape), k
            assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k
        assert torch.equal(got["targets"], torch.roll(got["tokens"], -1, 1))
        assert float(got["loss_mask"][:, :-1].min()) == 1.0
        assert float(got["loss_mask"][:, -1].max()) == 0.0

    def test_statistics_match_the_reference(self):
        jcfg, cfg = jax_get_config("internvl2_1b").reduced(), get_config("internvl2_1b").reduced()
        jsrc = JaxSyntheticLM(jcfg, JaxDataConfig(batch=16, seq_len=512, seed=1))
        src = SyntheticLM(cfg, DataConfig(batch=16, seq_len=512, seed=1), device="cpu")
        motifs = src._motifs.numpy()
        assert np.array_equal(motifs, np.asarray(jsrc._motifs))  # the same bank

        def stats(batches):
            toks = np.concatenate([np.asarray(b["tokens"]) for b in batches])
            tiled = np.tile(motifs, (1, toks.shape[1] // motifs.shape[1] + 1))[:, :toks.shape[1]]
            is_motif = (toks[:, None, :] == tiled[None]).all(-1).any(-1)
            uni = toks[~is_motif].ravel()
            head = [float((uni == i).mean()) for i in range(3)]
            prefix = np.concatenate([np.asarray(b["prefix_embeds"], np.float32).ravel()
                                     for b in batches])
            return head, float(is_motif.mean()), float(prefix.std())

        ref = stats([jsrc[i] for i in range(4)])
        got = stats([src[i] for i in range(4)])
        np.testing.assert_allclose(got[0], ref[0], atol=0.02)
        assert abs(got[1] - 0.5) <= 0.15 and abs(ref[1] - 0.5) <= 0.15
        assert abs(got[2] - 0.02) <= 0.001 and abs(ref[2] - 0.02) <= 0.001


def test_launch_train_runs_without_jax_and_the_loss_falls():
    """``python -m repro_torch.launch.train --arch internvl2_1b --tiny --device
    cpu --steps 20`` with ``jax`` and ``repro`` made unimportable."""
    probe = ("import sys\n"
             "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
             "import runpy\n"
             "sys.argv = ['train', '--arch', 'internvl2_1b', '--tiny', '--device', 'cpu', "
             "'--steps', '20', '--log-every', '1']\n"
             "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(line.split(" loss ")[1].split()[0]) for line in out.stdout.splitlines()
              if line.startswith("[train] step ")]
    assert len(losses) == 20 and losses[-1] < losses[0], out.stdout
    assert "[train] done: step 19 loss" in out.stdout
