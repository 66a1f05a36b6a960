from .from_jax import encoder_state_dict_from_jax, init_weights, state_dict_from_jax
from .hf_export import export_hf_processor

__all__ = ["encoder_state_dict_from_jax", "export_hf_processor", "init_weights", "state_dict_from_jax"]
