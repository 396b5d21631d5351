from .model import Model
from .param import (
    ParamSpec,
    cache_from_numpy,
    count_params,
    init_params,
    params_from_numpy,
    tree_map_specs,
)

__all__ = [
    "Model", "ParamSpec", "cache_from_numpy", "count_params", "init_params",
    "params_from_numpy", "tree_map_specs",
]
