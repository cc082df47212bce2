"""Client training backends, the cohort engine, the baselines, the fault
scenarios and live consensus serving (port of ``repro.fl``)."""
from repro_torch.fl.backend import CNNBackend, LMBackend
from repro_torch.fl.baselines import (ALGORITHMS, FLConfig,
                                      fedat_tier_weights, run_centralized,
                                      run_csafl, run_dagafl, run_dagfl,
                                      run_fedasync, run_fedat, run_fedavg,
                                      run_fedhisyn, run_independent,
                                      run_scalesfl)
from repro_torch.fl.cohort import (CNNCohortPrograms, CohortBackend,
                                   CohortPrograms, build_cohort_engine,
                                   parse_mesh_spec, perturb_update,
                                   register_cohort_programs,
                                   resolve_cohort_mesh)
from repro_torch.fl.scenarios import (SCENARIOS, Scenario, ScenarioConfig,
                                      as_scenario, dag_attack_metrics)
from repro_torch.fl.serving import (CNNQueryDriver, ConsensusPublisher,
                                    LMQueryDriver, QueryStream,
                                    ServingConfig, ServingReplica,
                                    consensus_over_refs, frontier_snapshot,
                                    make_query_driver, replica_parity,
                                    trees_bitwise_equal)

__all__ = ["CNNBackend", "LMBackend", "ALGORITHMS", "FLConfig",
           "run_centralized", "run_independent", "run_fedavg", "run_fedasync",
           "run_fedat", "run_csafl", "run_fedhisyn", "run_scalesfl",
           "run_dagfl", "run_dagafl", "fedat_tier_weights",
           "CohortBackend", "CohortPrograms", "CNNCohortPrograms",
           "build_cohort_engine", "perturb_update",
           "register_cohort_programs", "parse_mesh_spec",
           "resolve_cohort_mesh",
           "SCENARIOS", "Scenario", "ScenarioConfig", "as_scenario",
           "dag_attack_metrics",
           "ServingConfig", "ServingReplica", "ConsensusPublisher",
           "QueryStream", "CNNQueryDriver", "LMQueryDriver",
           "make_query_driver", "consensus_over_refs", "frontier_snapshot",
           "trees_bitwise_equal", "replica_parity"]
