"""Integrator configuration (port of pathtrace_tpu/integrator/config.py).

The reference's compile-time #defines (CudaUtil.cuh:15-19) as a frozen
dataclass, plus the two gradient switches, which leave the primal
unchanged: detach_sampling detaches the sampled direction, its pdf and the
Russian-roulette probability (megakernel.make_bounce_fn), and remat
checkpoints each lockstep iteration (megakernel.trace_paths_stats). The
fused CUDA engine renders primal only and reads neither.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    max_bounce: int = 8          # MAX_BOUNCE (CudaUtil.cuh:15)
    rr_bounce: int = 3           # RUSSIAN_ROULETTE_BOUNCE (CudaUtil.cuh:16)
    rr_stop_prob: float = 0.5    # PROB_STOP_BOUNCE (CudaUtil.cuh:17)
    refract_cap: int = 8         # RefractCnt > 8 breaks (CudaUtil.cuh:354)
    miss_radiance: tuple = (0.1, 0.1, 0.1)  # miss -> +0.1 gray (CudaUtil.cuh:377)
    pdf_clamp: float = 1e-2      # weight = eval/max(pdf, 1e-2)
    nee: bool = True             # next-event estimation on/off
    # Diffuse-lobe hemisphere sampling: "cosine" (production) or "uniform"
    # (the reference's sampling A/B, Bxdf.cuh:23-41; pdf 1/(2*pi)).
    hemisphere: str = "cosine"
    detach_sampling: bool = True
    remat: bool = False

    @property
    def max_iters(self) -> int:
        """Static bound on bounce-loop iterations: every iteration either
        consumes depth (< max_bounce of those) or a refraction credit
        (refract_cap + 2 events, pre-increment check `RefractCnt++ > 8`)."""
        return self.max_bounce + self.refract_cap + 2
