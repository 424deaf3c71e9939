from repro_torch.sharding.specs import (P, MeshShape, batch_spec,
                                        cache_pspecs, client_batch_spec,
                                        client_range, cohort_mesh, cohort_pspecs,
                                        cohort_shardings, param_pspecs,
                                        param_shardings, placements)

__all__ = ["MeshShape", "P", "batch_spec", "cache_pspecs",
           "client_batch_spec", "client_range", "cohort_mesh", "cohort_pspecs",
           "cohort_shardings", "param_pspecs", "param_shardings",
           "placements"]
