"""Roofline terms of a traced step on the H100 (the counterpart of
``repro/launch/hlo_analysis.py``).

All numbers are per device, from ``launch/op_cost.OpCounter`` over one
rank's local work:

    compute    = flops_per_device / 989e12      (dense bf16 tensor cores)
    memory     = hbm_bytes_per_device / 3.35e12 (HBM3)
    collective = wire_bytes_per_device / 50e9   (one 400 Gb/s NIC a card)

989 TFLOP/s and 3.35 TB/s are the H100 SXM data sheet's.  The collective
rate: on the production meshes (16 x 16 and 2 x 16 x 16) every group of 16
ranks spans more than one 8-card node, so a ring over it crosses the
network, where a card has one 400 Gb/s NIC, 50e9 bytes/s.  NVLink's 450
GB/s a direction (``NVLINK_BW``) carries only rings inside a node and is
noted, not used.

Nothing of the reference's TPU v5e constants is carried over, nor its
``cpu_bf16_inflation`` / ``tpu_corrected`` corrections: those undo
artefacts of XLA's CPU legalisation of bf16 (f32 twins of bf16 buffers,
f32 collectives), which a trace of eager ops at their real dtypes does not
have.  The reference's ``xla_*_once_counted`` (XLA's own cost analysis)
and its 2 us a collective latency floor have no counterpart here and are
reported as None.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

#: H100 SXM data sheet: dense bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
#: one 400 Gb/s NIC a card: what a ring across nodes gets
NET_BW = 50e9
#: NVLink 4, bytes/s a direction a card (rings inside one node; not used)
NVLINK_BW = 450e9
#: device memory of an H100 80GB
HBM_BYTES = 80e9


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float          # ring-model wire bytes
    collective_operand_bytes_per_device: float
    collective_bytes_by_kind: Dict[str, float]
    collective_count_by_kind: Dict[str, float]
    n_devices: int
    model_flops: float = 0.0                    # 6*N_active*D global
    xla_flops: Optional[float] = None           # no XLA here
    xla_bytes: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / NET_BW

    @property
    def t_collective_latency(self) -> Optional[float]:
        """No data-sheet latency a collective for the H100's network: not
        modelled (the counts are in ``collective_count_by_kind``)."""
        return None

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (traced FLOPs * devices): how much of the traced
        compute is useful; catches remat and redundant work."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful model FLOPs a device a bound-second against the peak: the
        MFU the step could at best reach (serial-term model)."""
        if self.t_bound <= 0:
            return 0.0
        useful_per_dev = self.model_flops / max(self.n_devices, 1)
        return useful_per_dev / self.t_bound / PEAK_FLOPS_BF16

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_operand_bytes_per_device":
                self.collective_operand_bytes_per_device,
            "collective_bytes_by_kind": dict(self.collective_bytes_by_kind),
            "collective_count_by_kind": dict(self.collective_count_by_kind),
            "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "xla_flops_once_counted": self.xla_flops,
            "xla_bytes_once_counted": self.xla_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_collective_latency_s": self.t_collective_latency,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_from_totals(tot: dict, n_devices: int,
                         model_flops: float = 0.0) -> Roofline:
    """A ``Roofline`` from ``op_cost.totals`` of a trace."""
    return Roofline(
        flops_per_device=float(tot["flops"]),
        bytes_per_device=float(tot["hbm_bytes"]),
        collective_bytes_per_device=float(sum(tot["wire_bytes"].values())),
        collective_operand_bytes_per_device=float(
            sum(tot["operand_bytes"].values())),
        collective_bytes_by_kind=dict(tot["wire_bytes"]),
        collective_count_by_kind=dict(tot["counts"]),
        n_devices=n_devices, model_flops=model_flops)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D for train (fwd+bwd), 2*N*D for inference, with
    N = active params (MoE: top-k experts only) and D = tokens processed."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
