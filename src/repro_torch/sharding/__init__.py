"""Sharding: TeAAL-mapping-driven PartitionSpec compilation + logical
axes (the reference's ``sharding`` package)."""
from .logical import (AxisRules, PartitionSpec, constrain, current_mesh,
                      default_rules, get_rules, set_mesh, set_rules,
                      spec_for)
from .compiler import compile_mapping, mapping_spec_for_step

__all__ = ["AxisRules", "PartitionSpec", "constrain", "current_mesh",
           "default_rules", "get_rules", "set_mesh", "set_rules",
           "spec_for", "compile_mapping", "mapping_spec_for_step"]
