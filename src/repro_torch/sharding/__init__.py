from repro_torch.sharding.specs import (MeshAxes, activation_sharding,
                                        even_regions, leaf_spec, make_axes,
                                        owner_of_row, param_specs,
                                        rank_region)

__all__ = ["MeshAxes", "activation_sharding", "even_regions", "leaf_spec",
           "make_axes", "owner_of_row", "param_specs", "rank_region"]
