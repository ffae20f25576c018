from .explicit_material import ExplicitMaterial, contract_to_unisphere

__all__ = ["ExplicitMaterial", "contract_to_unisphere"]
