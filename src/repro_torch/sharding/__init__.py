from repro_torch.sharding.specs import even_regions, owner_of_row, rank_region

__all__ = ["even_regions", "owner_of_row", "rank_region"]
