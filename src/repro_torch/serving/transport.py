"""Network simulation: fixed-capacity links + synthetic mobile traces.

Mirrors the paper's Mahimahi setup ({24-60 Mbps, 5-20 ms} fixed links and
real-world mobile traces). The pipeline asks for per-timestep capacity and
charges transfer time = RTT + bytes/rate; MadEye's NetworkEstimator sees
the *observed* rates (harmonic mean window), never the trace itself.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.transport import ar1_mobile_trace


@dataclass
class NetworkTrace:
    mbps: np.ndarray        # [T] capacity per timestep
    rtt_s: float = 0.02

    @classmethod
    def fixed(cls, mbps: float, rtt_ms: float, T: int) -> "NetworkTrace":
        return cls(np.full(T, float(mbps)), rtt_ms / 1e3)

    @classmethod
    def mobile(cls, T: int, base_mbps: float = 24.0, rtt_ms: float = 20.0,
               seed: int = 0) -> "NetworkTrace":
        """LTE-ish trace: AR(1) around base with occasional deep fades."""
        x = ar1_mobile_trace(T, base_mbps, np.random.default_rng(seed))
        return cls(x, rtt_ms / 1e3)

    def observed_mbps(self, t: int) -> float:
        return float(self.mbps[min(t, len(self.mbps) - 1)])
