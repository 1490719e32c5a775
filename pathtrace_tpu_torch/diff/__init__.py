from pathtrace_tpu_torch.diff.fd import fd_material_grad, fd_material_grad_auto
from pathtrace_tpu_torch.diff.grad import material_grads, material_jvp, render_with_params
from pathtrace_tpu_torch.diff.replay import (material_grads_replay, record_paths,
                                             replay_paths)
from pathtrace_tpu_torch.diff.wavetape import (material_grads_wavetape,
                                               record_paths_wavefront)

__all__ = [
    "material_grads", "material_jvp", "render_with_params",
    "fd_material_grad", "fd_material_grad_auto",
    "material_grads_replay", "record_paths", "replay_paths",
    "material_grads_wavetape", "record_paths_wavefront",
]
