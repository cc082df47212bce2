from repro_torch.sharding.rules import (MeshPlan, NamedSharding, P,
                                        batch_shardings, cache_shardings,
                                        opt_state_shardings, param_pspec,
                                        param_shardings, replicated)

__all__ = ["MeshPlan", "NamedSharding", "P", "param_pspec",
           "param_shardings", "opt_state_shardings", "batch_shardings",
           "cache_shardings", "replicated"]
