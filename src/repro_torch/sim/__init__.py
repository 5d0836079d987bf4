"""The simulator's water-fill solver on the card (twin of the `jax.jit`
solver of `repro.sim.alloc`)."""
