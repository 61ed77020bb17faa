"""Target-hardware constants for the α-β chunk planner
(:mod:`repro_torch.core.coordination`).

Counterpart of ``repro/hw.py``. ``V5E`` is a copy of the JAX package's TPU
v5e spec, kept only so that parity tests can plan exactly as ``repro``
does; the port plans against :data:`H100` by default. No field of ``V5E``
describes the card the port runs on.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class HWSpec:
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # bytes/s per chip
    ici_bw: float = 50e9              # bytes/s per link per direction
    ici_links: int = 1                # roofline term uses chips × link_bw
    hop_latency: float = 1e-6         # per ring hop (s)
    vmem_bytes: int = 128 * 1024**2   # on-chip staging memory per core
    hbm_bytes: int = 16 * 1024**3     # device memory per chip
    # inter-node tier (the slow ``tp_out`` axis of a hierarchical 2D mesh)
    dcn_bw: float = 12.5e9            # bytes/s per link per direction
    dcn_latency: float = 25e-6        # per inter-node hop (s)

    def inter_tier(self) -> "HWSpec":
        """This spec with the link terms replaced by the inter-node tier's,
        so α-β consumers can be pointed at the slow axis."""
        return replace(self, ici_bw=self.dcn_bw, hop_latency=self.dcn_latency)


# copy of repro.hw.V5E (TPU v5e): parity tests only
V5E = HWSpec()

# NVIDIA H100 SXM5 (80 GB). Sources: NVIDIA H100 Tensor Core GPU data sheet
# (SXM column, dense rates) and the NVIDIA Hopper architecture white paper;
# the two latencies are not on either and are assumptions, until
# ``repro_torch.plan.calibrate`` fits them from rows measured over NCCL on
# two or more cards (ROADMAP A13).
H100 = HWSpec(
    peak_flops=989e12,        # data sheet: BF16 Tensor Core, dense
    hbm_bw=3.35e12,           # data sheet: GPU memory bandwidth 3.35 TB/s
    ici_bw=450e9,             # data sheet: NVLink 900 GB/s, i.e. 450 each way
    ici_links=1,
    hop_latency=3e-6,         # assumption: one NCCL point-to-point step
    vmem_bytes=227 * 1024,    # white paper: shared memory per block, 227 KB
    hbm_bytes=80 * 10**9,     # data sheet: GPU memory 80 GB
    dcn_bw=50e9,              # data sheet: ConnectX-7 NDR 400 Gb/s per GPU
    dcn_latency=10e-6,        # assumption: one InfiniBand hop between nodes
)
