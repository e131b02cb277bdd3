"""ltx_jax — LTX-2 video/audio diffusion in JAX, run on NVIDIA GPUs.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the
VincentGourbin/ltx-video-swift-mlx reference (Apple-Silicon/MLX, Swift):
LTX-2 19B text-to-video / image-to-video / video+audio flow-matching
diffusion, Gemma-3-12B text encoding, causal-3D-conv video VAE,
2x latent upscaling, LoRA fusion, int8/int4 weight quantization.

Design:
  * the denoise step is one jit-compiled function (patchify -> DiT scan ->
    Euler) with static shapes,
  * guidance branches (cond/uncond/STG) are batched over the mesh `data`
    axis instead of run serially,
  * the DiT is tensor-parallel over heads/FFN via NamedSharding on a
    (data, model) mesh; long sequences shard over a `seq` axis,
  * attention picks per platform and shape between cuDNN, a Pallas
    (Triton) flash kernel and plain XLA (ops/attention.py); the kernel
    runs in the Pallas interpreter in the CPU tests.
"""

__version__ = "0.1.0"
