"""The port's simulators: the discrete-event simulator of the paper's
testbed with its Table-1 harness, and the batched fluid engine with its
scenario library."""
from repro_torch.envsim.batched import (N_OBS_MODALITIES,
                                        FluidIngredients, FluidParams,
                                        FluidResult, FluidState, WindowInfo,
                                        fluid_params_from_numpy,
                                        fluid_state_from_numpy,
                                        fluid_window_step, init_fluid_state,
                                        make_env_step, make_scenario_env_step,
                                        params_from_config, run_fluid,
                                        summarize)
from repro_torch.envsim.chaos import (CHAOS_INFO, CHAOS_PRESETS, ChaosInfo,
                                      capacity_flap, crash_restart_storm,
                                      long_outage, straggler_episodes,
                                      zone_outage)
from repro_torch.envsim.config import (TIER_CLASSES, SimConfig, TierConfig,
                                       default_tiers, discretization_for,
                                       sim_config_for, tiers_for_topology)
from repro_torch.envsim.harness import (StrategySummary, evaluate_strategy,
                                        table1)
from repro_torch.envsim.routers import AifRouter
from repro_torch.envsim.scenarios import (SCENARIOS, Profile, ScenarioBatch,
                                          build_scenario, compile_scenario,
                                          compose, pad_scenario,
                                          scrape_blackout,
                                          stale_replay, telemetry_dropout)
from repro_torch.envsim.simulator import (EdgeSimulator, MetricsSnapshot,
                                          RunResult, run_experiment)

__all__ = ["StrategySummary", "evaluate_strategy", "table1", "AifRouter",
           "EdgeSimulator", "MetricsSnapshot", "RunResult", "run_experiment",
           "N_OBS_MODALITIES", "FluidIngredients", "FluidParams", "FluidResult", "FluidState",
           "WindowInfo", "fluid_params_from_numpy", "fluid_state_from_numpy",
           "fluid_window_step", "init_fluid_state", "make_env_step",
           "make_scenario_env_step", "params_from_config", "run_fluid",
           "summarize", "TIER_CLASSES", "SimConfig", "TierConfig",
           "default_tiers", "discretization_for", "sim_config_for",
           "tiers_for_topology", "SCENARIOS", "Profile", "ScenarioBatch",
           "build_scenario", "compile_scenario", "compose", "pad_scenario",
           "scrape_blackout", "stale_replay", "telemetry_dropout",
           "CHAOS_INFO", "CHAOS_PRESETS", "ChaosInfo", "capacity_flap",
           "crash_restart_storm", "long_outage", "straggler_episodes",
           "zone_outage"]

