"""Fleet heterogeneity: latency tables, availability and speed models,
named presets, and the engine's per-instance ``ScenarioPlan``."""
from repro_torch.scenarios.availability import (AlwaysOn, Churn, Diurnal,
                                                RegionalChurn, RenewalChurn,
                                                SpeedModel)
from repro_torch.scenarios.registry import (Scenario, ScenarioPlan,
                                            TableAssignment, draw_table_ids,
                                            get_scenario,
                                            legacy_latency_scenario,
                                            register_scenario,
                                            scenario_from_trace,
                                            scenario_names, scenario_plan)
from repro_torch.scenarios.tables import (LatencyTable, alias_sample,
                                          alias_sample_rows, implied_probs,
                                          key_uniforms, vose_alias)

__all__ = ["AlwaysOn", "Churn", "Diurnal", "LatencyTable", "RegionalChurn",
           "RenewalChurn", "Scenario", "ScenarioPlan", "SpeedModel",
           "TableAssignment", "alias_sample", "alias_sample_rows",
           "draw_table_ids", "get_scenario", "implied_probs", "key_uniforms",
           "legacy_latency_scenario", "register_scenario",
           "scenario_from_trace", "scenario_names", "scenario_plan",
           "vose_alias"]
