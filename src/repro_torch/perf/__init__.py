"""Analytic cost models of the port: FLOP counts per cell (``flops``),
hardware constants with the H100 the port runs on (``hardware``), the
collective inventory of an HLO text (``hlo``) and the three-term roofline
(``roofline``). They turn a model's FLOPs and bytes into a service time
(``core.service_time.from_roofline``); ``flops.param_counts`` also feeds the
measurement harness's simulated clock. Copies of the reference's ``perf``
modules, with one fix (ROADMAP C12, in ``roofline``)."""

from .flops import CellFlops, cell_flops, param_counts
from .hardware import CLIENT_NPU, DEVICE_TIER_V5E_1, H100_SXM, TPU_V5E, HardwareSpec
from .hlo import DTYPE_BYTES, CollectiveStats, parse_collectives
from .roofline import RooflineReport, combine_linear, report_from_counts

__all__ = [
    "CellFlops", "cell_flops", "param_counts",
    "HardwareSpec", "TPU_V5E", "DEVICE_TIER_V5E_1", "CLIENT_NPU", "H100_SXM",
    "CollectiveStats", "parse_collectives", "DTYPE_BYTES",
    "RooflineReport", "combine_linear", "report_from_counts",
]
