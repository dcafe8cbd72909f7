"""Hand-written kernels, each beside the plain jnp form it must beat.

* mips_reservoir — the top-2-per-slot reservoir scan for serving, as a
  Pallas kernel through Triton and as plain blocked XLA GEMMs.

`nmftpu.backend` decides which form runs; the kernel is tested against
the plain form in the Pallas interpreter on the CPU.
"""
