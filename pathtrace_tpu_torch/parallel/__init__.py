from pathtrace_tpu_torch.parallel.mesh import (RAY_AXIS, RayMesh, make_ray_mesh,
                                               render_fused_sharded, render_grad_sharded,
                                               render_sharded, render_wavefront_sharded,
                                               train_step_replay_sharded,
                                               train_step_wavetape,
                                               train_step_wavetape_sharded)

__all__ = ["RAY_AXIS", "RayMesh", "make_ray_mesh", "render_sharded", "render_grad_sharded",
           "render_wavefront_sharded", "render_fused_sharded", "train_step_replay_sharded",
           "train_step_wavetape_sharded", "train_step_wavetape"]
