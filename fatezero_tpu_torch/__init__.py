"""PyTorch/CUDA port of fatezero_tpu: FateZero zero-shot video editing.

The JAX package ``fatezero_tpu`` is the reference; each module here has a
counterpart of the same name there, with the same public layouts
([B, F, H, W, C] video, [B, F, S, C] tokens, [B, F, H, S, D] heads). This
package imports torch and never jax.
"""
