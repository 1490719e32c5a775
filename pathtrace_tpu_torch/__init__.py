"""pathtrace_tpu_torch - the PyTorch + CUDA port of pathtrace_tpu.

Module paths mirror the JAX package (utils/rng.py, models/scene.py,
integrator/wavefront.py, ...) so each counterpart is found by name. The
package imports torch and never jax; the JAX package stays the reference
its tests are held against.

The fused engine's bounce kernel is CUDA C++ (csrc/bounce_kernel.cu),
built by nvcc at first use (ops/cuda/build.py). Importing this package
never builds anything and needs neither nvcc nor a GPU.
"""

__version__ = "0.1.0"
