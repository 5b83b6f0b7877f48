"""Hardware models for HyperParallel-MoE — copy of ``repro.core.hardware``.

* ``AscendA3`` — the paper's evaluation platform. Used by the discrete-event
  simulator (``core/simulator.py``) to reproduce Table 3 / Figs 7-10. The
  constants come from the paper (§2.1, §5.2) and public Ascend material:
  25 AI Cores per die → 25 AIC units + 50 AIV units, a 192 MB shared L2 with
  >4x HBM read bandwidth, and profiler-reported ~67% average MAC utilisation
  for GMM under the serialized baseline.

* ``Topology`` — the two-level EP cluster the compiler and simulator
  price links on.

* ``NvidiaH100`` (``H100``) — the card the port runs on: the peak rates
  that every bound and roofline of the port divides by (``chip_smoke.py``,
  ``parallel/roofline.py``, the kernel benchmarks). It stands where the
  reference keeps its ``TPUv5e`` roofline constants, which are not copied.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AscendA3:
    """Per-device constants for one Ascend A3 device (paper §2.1/§5.2)."""

    num_aic: int = 25                 # AI Cube (matrix) units
    num_aiv: int = 50                 # AI Vector units
    # Cube throughput. A3-class dies deliver a few hundred TFLOP/s bf16; the
    # exact figure is not in the paper, so we calibrate the simulator against
    # the paper's measured baseline (Table 3) and keep the per-unit split.
    aic_tflops_bf16: float = 14.0     # per AIC unit → 350 TFLOP/s per die
    # Per-tile GMM efficiency by operand residency: tiles streaming inputs
    # from the shared L2 (>4× HBM read bw) keep the MXU fed better than
    # HBM-streaming tiles. This is the mechanism behind cache-guided GMM
    # interleaving's backward-pass win (§4.5).
    aic_eff_hbm: float = 0.80
    aic_eff_l2: float = 0.90
    aiv_gbps: float = 22.0            # per AIV unit effective vector GB/s
    # (calibrated against the Fig 9 serial SwiGLU+Add latency at M=32K)
    l2_bytes: int = 192 * 2**20       # shared AIC/AIV L2
    l2_read_x_hbm: float = 4.0        # L2 read bw ≥ 4x HBM (paper §2.1)
    hbm_gbps: float = 1600.0          # HBM bandwidth per device
    # Inter-device EP bandwidth. A3 SuperPod-class unified-bus interconnect;
    # calibrated so the simulated operator-by-operator baseline lands on the
    # paper's measured Table 3 numbers (see EXPERIMENTS.md §Calibration).
    link_gbps: float = 350.0
    # Measured per-task dispatch overheads (paper §6.2).
    static_dispatch_us: float = 0.1
    dynamic_dispatch_us: float = 2.36
    # Per-message link latency floor for remote put_mem_signal transfers.
    # Without it a 64-byte and a 64-KB message differ only linearly in
    # bytes, so fine-grained tile comm is mispriced as free.
    hop_latency_us: float = 0.35
    # Host-side collective launch + sync overhead per AllToAll phase for the
    # operator-by-operator baseline (exposed, not overlappable).
    collective_host_us: float = 120.0
    kernel_launch_us: float = 20.0    # per-kernel launch gap in the baseline


@dataclasses.dataclass(frozen=True)
class Topology:
    """Two-level EP cluster topology: fast intra-node links, slow uplinks.

    Ranks ``[k*ranks_per_node, (k+1)*ranks_per_node)`` form node ``k``.
    Every (src, dst) rank pair maps to one of three link classes:

    * ``"local"`` — src == dst, an HBM copy, never touches a link;
    * ``"intra"`` — same node, unified-bus/HCCS-class bandwidth;
    * ``"inter"`` — different nodes, NIC-class bandwidth with a much
      higher per-hop latency.

    The class is what the cost model, the simulator's link clocks, and
    the two-level dispatch emitter all key on — it must stay a pure
    function of the rank pair.
    """

    ranks_per_node: int = 4
    intra_gbps: float = 350.0         # matches AscendA3.link_gbps
    inter_gbps: float = 50.0          # RDMA-NIC-class uplink per rank
    intra_hop_us: float = 0.35        # per-message latency, intra-node
    inter_hop_us: float = 2.0         # per-message latency, cross-node

    def __post_init__(self) -> None:
        if self.ranks_per_node < 1:
            raise ValueError("ranks_per_node must be >= 1")
        if self.intra_gbps <= 0 or self.inter_gbps <= 0:
            raise ValueError("link bandwidths must be positive")
        if self.intra_hop_us < 0 or self.inter_hop_us < 0:
            raise ValueError("hop latencies must be non-negative")

    def node_of(self, rank: int) -> int:
        return rank // self.ranks_per_node

    def n_nodes(self, ep: int) -> int:
        if ep % self.ranks_per_node:
            raise ValueError(
                f"ep={ep} is not a multiple of ranks_per_node="
                f"{self.ranks_per_node}")
        return ep // self.ranks_per_node

    def same_node(self, a: int, b: int) -> bool:
        return self.node_of(a) == self.node_of(b)

    def link_class(self, src: int, dst: int) -> str:
        if src == dst:
            return "local"
        return "intra" if self.same_node(src, dst) else "inter"

    def bw_gbps(self, link_class: str) -> float:
        return self.intra_gbps if link_class == "intra" else self.inter_gbps

    def latency_us(self, link_class: str) -> float:
        return (self.intra_hop_us if link_class == "intra"
                else self.inter_hop_us)

    def key(self) -> tuple:
        """Hashable identity for schedule-cache keys (``core/ssc.py``)."""
        return (self.ranks_per_node, self.intra_gbps, self.inter_gbps,
                self.intra_hop_us, self.inter_hop_us)


@dataclasses.dataclass(frozen=True)
class NvidiaH100:
    """Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet: dense, no
    sparsity, at the full 700 W power limit; a card set lower runs slower
    under load)."""

    peak_flops_bf16: float = 989e12       # FLOP/s on the tensor cores
    peak_flops_fp32: float = 67e12        # FLOP/s outside the tensor cores
    hbm_bytes_per_s: float = 3.35e12
    hbm_bytes: int = 80 * 10**9
    # One direction of the card's NVLink. Carried, not used: the port's
    # cells run on one card and have no collective term.
    nvlink_bytes_per_s: float = 450e9

    def peak_flops(self, dtype) -> float:
        """The peak of a compute dtype (``torch.bfloat16``/``float32`` or
        its name)."""
        name = str(dtype).removeprefix("torch.")
        if name == "bfloat16":
            return self.peak_flops_bf16
        if name == "float32":
            return self.peak_flops_fp32
        raise ValueError(f"no peak rate for {dtype!r}")


H100 = NvidiaH100()
