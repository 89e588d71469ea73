"""smalltts_tpu_torch: the PyTorch/CUDA port of smalltts_tpu for NVIDIA Hopper.

The serving path (codec encode -> style/text encoders -> DMD 4-step DiT ->
fp32 codec decode -> batcher) runs on the card through hand-written kernels
in `csrc/` (built with nvcc at first use, see ops/kernels). The package
imports neither JAX nor the JAX package; it keeps its own copies of the host
modules it needs.
"""
