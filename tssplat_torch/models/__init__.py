from .networks import (Module, create_network_with_input_encoding,
                       frequency_encoding, get_activation, get_encoding,
                       get_mlp, hash_grid_encoding,
                       progressive_band_hash_grid, scale_tensor,
                       sphere_init_mlp, vanilla_mlp)

__all__ = ["Module", "create_network_with_input_encoding",
           "frequency_encoding", "get_activation", "get_encoding", "get_mlp",
           "hash_grid_encoding", "progressive_band_hash_grid", "scale_tensor",
           "sphere_init_mlp", "vanilla_mlp"]
