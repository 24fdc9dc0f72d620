from .from_jax import params_from_jax, state_from_jax
