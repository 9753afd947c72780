"""Accelerator database + analytic collective/compute cost model.

The port of ``tepdist_tpu/parallel/performance_utils.py`` (reference
parity: ``PerfUtils::{CalculateFlops, AllReduceCost, AllToAllCost,
AllGatherCost}``, service/parallel/performance_utils.{h,cc}, and the
V100/NVLink constants in ``Evaluator``, parallel/evaluator.h:52-56). The
constants are per chip: tensor-core TFLOP/s, HBM capacity and GB/s, the
intra-node link (NVLink on the H100; the field names are the reference's
``ici_*``) and the link off the node (the reference's ``dcn_gbps``). The
collective formulas are the standard alpha-beta ring costs.

The ``h100`` entry is NVIDIA's H100 SXM5 80GB data sheet: 989 dense bf16
TFLOP/s, 80 GB of HBM3 at 3350 GB/s, NVLink 4 with 18 links of 25 GB/s
each way, and 50 GB/s (400 Gb/s NDR InfiniBand) off the node. The ``cpu``
entry is the JAX package's test target, unchanged. The numbers feed a
*relative* cost model, so small inaccuracies only matter if they flip a
planning decision; ``telemetry/calibrate.py`` replaces them with measured
rates when a profile is active.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from tepdist_tpu_torch.core.service_env import ServiceEnv


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float          # peak dense bf16 TFLOP/s per chip
    hbm_gb: float               # HBM capacity per chip
    hbm_gbps: float             # HBM bandwidth GB/s
    ici_gbps_per_link: float    # intra-node link GB/s per direction
    ici_links: int              # intra-node links per chip
    dcn_gbps: float             # off-node bandwidth per chip, GB/s


# Spec-sheet numbers (module docstring).
CHIPS: Dict[str, ChipSpec] = {
    "h100": ChipSpec("h100", 989.0, 80.0, 3350.0, 25.0, 18, 50.0),
    # Virtual CPU target used by the test harness; tiny numbers keep the
    # planner's relative decisions realistic while making tests deterministic.
    "cpu": ChipSpec("cpu", 0.1, 8.0, 50.0, 1.0, 2, 1.0),
}


# The links a send to a ring neighbour crosses, by chip: on an NVSwitch
# node every link of the card reaches every peer (the data sheet's 18 x 25
# GB/s each way), where a torus neighbour (the reference's chips, the
# ``cpu`` target) is one link away, the default. It sits beside ChipSpec,
# whose fields stay the reference's TpuChipSpec's.
NEIGHBOUR_LINKS: Dict[str, int] = {"h100": 18}


def chip_spec(generation: str | None = None) -> ChipSpec:
    """The chip named by ``generation`` or the TPU_GENERATION knob (the
    reference's name; ``h100`` by default in the port), with the
    ICI_BANDWIDTH, DCN_BANDWIDTH and HBM_GB overrides applied."""
    gen = generation or ServiceEnv.get().tpu_generation
    spec = CHIPS.get(gen.lower())
    if spec is None:
        raise KeyError(f"unknown chip {gen!r}; known: {list(CHIPS)}")
    env = ServiceEnv.get()
    if env.ici_bandwidth > 0 or env.dcn_bandwidth > 0 or env.hbm_gb > 0:
        spec = dataclasses.replace(
            spec,
            ici_gbps_per_link=(env.ici_bandwidth if env.ici_bandwidth > 0
                               else spec.ici_gbps_per_link),
            dcn_gbps=(env.dcn_bandwidth if env.dcn_bandwidth > 0
                      else spec.dcn_gbps),
            hbm_gb=(env.hbm_gb if env.hbm_gb > 0 else spec.hbm_gb),
        )
    return spec


GB = 1e9
# Fixed per-collective launch latency (the "alpha" term), seconds: a small
# constant suffices for ranking.
ALPHA_S = 2e-6

# Wire-byte shrink factor per communication dtype relative to f32 payloads.
# "" / "float32" = fidelity (no compression). The evaluator prices every
# gradient collective once per dtype and the argmin decides per candidate
# (EQuARX, arXiv:2506.17615: quantized AllReduce at ~2x).
COMM_DTYPE_RATIOS: Dict[str, float] = {
    "": 1.0,
    "float32": 1.0,
    "bfloat16": 0.5,
    "int8": 0.25,
}

# Optimizer-state bytes per gradient byte (ZeRO pricing, arXiv:2004.13336).
# Adam keeps two fp32 moments per fp32 param, so the state is ~2x the
# param/grad payload; SGD-with-momentum is 1x and plain SGD 0x, but the
# planner prices the worst common case — over-estimating state for a
# stateless optimizer only makes a feasible plan look tighter, never
# flips a ranking between two candidates (both carry the same factor).
OPT_STATE_FACTOR = 2.0


def param_wire_dtype(comm_dtype: str) -> str:
    """Wire dtype for the ZeRO updated-param all-gather under a comm-dtype
    modifier. Gradients tolerate int8 fake-quant (stochastic rounding keeps
    the expectation), but PARAMS quantized to int8 every step would
    accumulate bias directly into the weights — so int8 plans gather params
    at bf16, the asymmetry EQuARX also keeps."""
    if comm_dtype == "int8":
        return "bfloat16"
    return comm_dtype


def _calib():
    """The active calibration profile (telemetry/calibrate.py) or None.
    Lazy import: calibrate has no module-level dependency on this module,
    but keeping the import inside the call avoids any telemetry<->parallel
    import cycle and costs one cached-module lookup."""
    from tepdist_tpu_torch.telemetry.calibrate import active_profile
    return active_profile()


class PerfUtils:
    """Alpha-beta ring-cost formulas over a mesh axis of ``n`` chips.

    All costs in seconds for ``bytes_`` payload per participating chip:
    reduce-scatter + all-gather for all-reduce, neighbor exchanges for
    all-to-all (NCCL's ring algorithms).
    """

    @staticmethod
    def _bw(spec: ChipSpec, over_dcn: bool) -> float:
        prof = _calib()
        if prof is not None and prof.ar_bytes_per_s > 0:
            # Measured ring bandwidth replaces the spec-sheet link math —
            # the profile already folds in topology and software overhead.
            return prof.ar_bytes_per_s
        # Within a node every link of the chip carries the ring: NVSwitch
        # joins all cards (the CPU target's 2 links are the reference's
        # two torus links of one axis).
        return (spec.dcn_gbps if over_dcn
                else spec.ici_links * spec.ici_gbps_per_link) * GB

    @classmethod
    def all_reduce_cost(cls, bytes_: float, n: int, spec: ChipSpec | None = None,
                        over_dcn: bool = False) -> float:
        if n <= 1:
            return 0.0
        spec = spec or chip_spec()
        bw = cls._bw(spec, over_dcn)
        return ALPHA_S * (n - 1) + 2.0 * bytes_ * (n - 1) / (n * bw)

    @classmethod
    def all_gather_cost(cls, bytes_: float, n: int, spec: ChipSpec | None = None,
                        over_dcn: bool = False) -> float:
        """``bytes_`` = full (gathered) size."""
        if n <= 1:
            return 0.0
        spec = spec or chip_spec()
        bw = cls._bw(spec, over_dcn)
        return ALPHA_S * (n - 1) + bytes_ * (n - 1) / (n * bw)

    reduce_scatter_cost = all_gather_cost  # identical ring cost shape

    @classmethod
    def all_to_all_cost(cls, bytes_: float, n: int, spec: ChipSpec | None = None,
                        over_dcn: bool = False) -> float:
        """``bytes_`` = per-chip resident size; each chip keeps 1/n, sends the
        rest. On a bidirectional ring the bisection limits throughput to
        ~bytes*(n/4)/bw; use the exact ring formula bytes*(n^2-1)/(4n)/bw
        ~= bytes*n/4 for large n."""
        if n <= 1:
            return 0.0
        spec = spec or chip_spec()
        bw = cls._bw(spec, over_dcn)
        return ALPHA_S * (n - 1) + bytes_ * (n * n - 1) / (4.0 * n * bw)

    @classmethod
    def ppermute_cost(cls, bytes_: float, spec: ChipSpec | None = None,
                      over_dcn: bool = False) -> float:
        """One neighbor hop (ring attention / pipeline send-recv) over the
        chip's ``NEIGHBOUR_LINKS``: one link on a torus, every link of the
        card through a switch."""
        prof = _calib()
        if prof is not None and prof.transfer_bytes_per_s > 0:
            return ALPHA_S + bytes_ / prof.transfer_bytes_per_s
        spec = spec or chip_spec()
        links = NEIGHBOUR_LINKS.get(spec.name, 1)
        return ALPHA_S + bytes_ / (links * spec.ici_gbps_per_link * GB
                                   if not over_dcn else spec.dcn_gbps * GB)

    @classmethod
    def compute_time(cls, flops: float, spec: ChipSpec | None = None,
                     mxu_util: float = 0.5) -> float:
        spec = spec or chip_spec()
        t = flops / (spec.bf16_tflops * 1e12 * mxu_util)
        prof = _calib()
        if prof is not None and prof.compute_scale > 0:
            t *= prof.compute_scale
        return t

    @classmethod
    def hbm_time(cls, bytes_: float, spec: ChipSpec | None = None) -> float:
        spec = spec or chip_spec()
        t = bytes_ / (spec.hbm_gbps * GB)
        prof = _calib()
        if prof is not None and prof.hbm_scale > 0:
            t *= prof.hbm_scale
        return t

    # -- compressed collectives (comm-dtype candidate modifiers) ----------
    @classmethod
    def quantize_overhead(cls, bytes_: float, comm_dtype: str,
                          spec: ChipSpec | None = None) -> float:
        """Quantize + dequantize compute term per participating tensor,
        modeled as HBM passes over the fidelity payload: one read + one
        write on each side for the cast, plus one extra read for int8's
        per-chunk max-abs scale pass. Element-wise, so bandwidth-bound —
        never bound by the tensor cores."""
        ratio = COMM_DTYPE_RATIOS.get(comm_dtype, 1.0)
        if ratio >= 1.0 or bytes_ <= 0:
            return 0.0
        passes = 2.0 if comm_dtype != "int8" else 3.0
        return 2.0 * cls.hbm_time(passes * bytes_, spec)

    @classmethod
    def compressed_all_reduce_cost(
            cls, bytes_: float, n: int, comm_dtype: str,
            spec: ChipSpec | None = None,
            over_dcn: bool = False) -> float:
        """Ring all-reduce over the SHRUNK wire bytes plus the
        quantize/dequantize term; degenerates to the fidelity cost for
        ""/float32."""
        ratio = COMM_DTYPE_RATIOS.get(comm_dtype, 1.0)
        return (cls.all_reduce_cost(bytes_ * ratio, n, spec, over_dcn)
                + cls.quantize_overhead(bytes_, comm_dtype, spec))

    @classmethod
    def compressed_all_gather_cost(
            cls, bytes_: float, n: int, comm_dtype: str,
            spec: ChipSpec | None = None,
            over_dcn: bool = False) -> float:
        ratio = COMM_DTYPE_RATIOS.get(comm_dtype, 1.0)
        return (cls.all_gather_cost(bytes_ * ratio, n, spec, over_dcn)
                + cls.quantize_overhead(bytes_, comm_dtype, spec))

    @classmethod
    def zero_update_cost(cls, grad_bytes: float, dp: int, comm_dtype: str,
                         spec: ChipSpec | None = None,
                         over_dcn: bool = False) -> float:
        """ZeRO-1 weight-update collectives over a DP axis of ``dp``
        (arXiv:2004.13336): reduce-scatter the accumulated gradient, apply
        on the local 1/dp shard, all-gather the updated params. Composes
        with the comm-dtype modifier on BOTH collectives (grads at
        ``comm_dtype``, params at :func:`param_wire_dtype`). Note
        RS + AG at equal bytes = ring AR + one extra alpha sweep, so ZeRO
        never wins on pure seconds — it wins by making optimizer state
        1/dp per device (memory feasibility)."""
        if dp <= 1:
            return 0.0
        rs_ratio = COMM_DTYPE_RATIOS.get(comm_dtype, 1.0)
        ag_dtype = param_wire_dtype(comm_dtype)
        ag_ratio = COMM_DTYPE_RATIOS.get(ag_dtype, 1.0)
        return (cls.reduce_scatter_cost(grad_bytes * rs_ratio, dp, spec,
                                        over_dcn)
                + cls.quantize_overhead(grad_bytes, comm_dtype, spec)
                + cls.all_gather_cost(grad_bytes * ag_ratio, dp, spec,
                                      over_dcn)
                + cls.quantize_overhead(grad_bytes, ag_dtype, spec))

    @classmethod
    def compressed_ppermute_cost(
            cls, bytes_: float, comm_dtype: str,
            spec: ChipSpec | None = None,
            over_dcn: bool = False) -> float:
        """One neighbor hop on the shrunk wire (pipeline SEND/RECV with a
        compressed activation payload)."""
        ratio = COMM_DTYPE_RATIOS.get(comm_dtype, 1.0)
        return (cls.ppermute_cost(bytes_ * ratio, spec, over_dcn)
                + cls.quantize_overhead(bytes_, comm_dtype, spec))
