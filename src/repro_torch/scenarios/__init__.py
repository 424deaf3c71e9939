from repro_torch.scenarios.registry import (AlwaysOn, Scenario,
                                            ScenarioPlan, get_scenario,
                                            legacy_latency_scenario)
from repro_torch.scenarios.tables import LatencyTable

__all__ = ["AlwaysOn", "LatencyTable", "Scenario", "ScenarioPlan",
           "get_scenario", "legacy_latency_scenario"]
