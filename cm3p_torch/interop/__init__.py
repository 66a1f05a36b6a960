from .from_jax import encoder_state_dict_from_jax, init_weights, state_dict_from_jax

__all__ = ["encoder_state_dict_from_jax", "init_weights", "state_dict_from_jax"]
