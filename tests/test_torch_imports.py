"""The port stands alone: no file of ``rlgpuschedule_tpu_torch`` and not
``chip_smoke.py`` imports JAX, Flax or the JAX package, and importing the
serving or the training path does not pull JAX in through a
dependency."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rlgpuschedule_tpu")


def _port_files():
    pkg = os.path.join(ROOT, "rlgpuschedule_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_has_the_expected_files():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert len(names) > 20
    assert "rlgpuschedule_tpu_torch/serve/fleet.py" in names
    assert "rlgpuschedule_tpu_torch/train.py" in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def _leaves_jax_out(modules):
    code = ("import sys, "
            + ", ".join(f"rlgpuschedule_tpu_torch.{m}" for m in modules)
            + "; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_importing_the_serving_path_leaves_jax_out():
    _leaves_jax_out(("serve.fleet", "serve.engine", "serve.__main__"))


def test_importing_the_training_path_leaves_jax_out():
    _leaves_jax_out(("train", "experiment", "algos", "ops.gae"))


def test_importing_the_evaluation_path_leaves_jax_out():
    _leaves_jax_out(("evaluate", "eval", "sim.oracle", "sim.schedulers",
                     "native", "traces.philly", "traces.pai"))


def test_importing_the_preemptive_and_graph_path_leaves_jax_out():
    _leaves_jax_out(("decision", "sim.core", "env.obs", "env.rewards",
                     "models.actor_critic", "models.encoders",
                     "models.convert", "serve.engine"))


def test_importing_the_policy_server_path_leaves_jax_out():
    _leaves_jax_out(("serve", "serve.batching", "serve.bench",
                     "serve.engine", "serve.__main__", "obs", "obs.events",
                     "obs.metrics", "obs.slo", "obs.trace",
                     "analysis.sentinels"))


def test_the_policy_server_slice_has_its_pieces():
    """The serving stack and the telemetry it reports through are the
    port's own modules, not re-exports."""
    import importlib
    sys.path.insert(0, ROOT)
    try:
        for mod, names in {
                "serve.batching": ("PolicyServer", "Reservoir", "Ewma",
                                   "ServeResult", "DeadlineSheddedError",
                                   "ServerClosedError", "stack_requests",
                                   "scatter_results"),
                "serve.bench": ("build_request_pool", "run_bench",
                                "run_soak", "run_host_path", "StubEngine"),
                "obs.metrics": ("Registry", "MetricsHTTPServer",
                                "serve_http"),
                "obs.events": ("EventBus", "merge_dir"),
                "obs.trace": ("Tracer", "TracerLane"),
                "obs.slo": ("SLOEngine", "SLOSpec", "histogram_sli"),
                "analysis.sentinels": ("CompileCounter",
                                       "no_implicit_transfers",
                                       "RecompileSentinelError")}.items():
            m = importlib.import_module(f"rlgpuschedule_tpu_torch.{mod}")
            for n in names:
                assert getattr(m, n).__module__ == m.__name__, (mod, n)
    finally:
        sys.path.remove(ROOT)


def test_the_preemptive_and_graph_slice_has_its_pieces():
    """The modules this slice extends carry the pieces it ports, each
    defined in the port itself (not re-exported from elsewhere)."""
    import importlib
    sys.path.insert(0, ROOT)
    try:
        for mod, names in {
                "sim.core": ("spread_placement", "placement", "preempt",
                             "running_queue", "attained_service"),
                "env.obs": ("run_features", "build_adjacency",
                            "graph_obs"),
                "env.rewards": ("preempt_charge",),
                "models.encoders": ("GNNEncoder",),
                "models.actor_critic": ("GNNActorCritic",),
                "decision": ("preempt_slice", "stall_threshold",
                             "gate_stalled")}.items():
            m = importlib.import_module(f"rlgpuschedule_tpu_torch.{mod}")
            for n in names:
                assert getattr(m, n).__module__ == m.__name__, (mod, n)
    finally:
        sys.path.remove(ROOT)


def test_the_evaluation_slice_has_its_files():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for f in ("evaluate.py", "cli.py", "eval.py", "sim/oracle.py",
              "sim/schedulers.py",
              "native/__init__.py", "traces/philly.py", "traces/pai.py"):
        assert f"rlgpuschedule_tpu_torch/{f}" in names, f
    assert os.path.isfile(os.path.join(ROOT, "rlgpuschedule_tpu_torch",
                                       "native", "fast_oracle.cpp"))


def test_the_native_engine_builds_from_the_ports_own_source():
    """The loader compiles the port's copy of ``fast_oracle.cpp`` and
    names no file of the JAX package; its cache is the port's own."""
    from rlgpuschedule_tpu_torch import native
    port_native = os.path.join(ROOT, "rlgpuschedule_tpu_torch", "native")
    assert os.path.dirname(os.path.realpath(native.SRC)) == port_native
    assert native.NativeEngine().src == native.SRC
    assert native.cache_dir().endswith("rlgpuschedule_tpu_torch")
    src = open(os.path.join(port_native, "__init__.py"),
               encoding="utf-8").read()
    assert "rlgpuschedule_tpu/" not in src
    assert "rlgpuschedule_tpu\"" not in src


def test_the_evaluate_cli_does_not_depend_on_the_train_cli():
    """The two CLIs are peers: what they share lives in ``cli.py``."""
    path = os.path.join(ROOT, "rlgpuschedule_tpu_torch", "evaluate.py")
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    relative = {(node.module, a.name) for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.level
                for a in node.names}
    assert not {m for m, n in relative if m == "train" or n == "train"}
    assert ("cli", "add_config_flags") in relative


def test_importing_the_checkpoint_and_full_trace_path_leaves_jax_out():
    _leaves_jax_out(("checkpoint", "select_checkpoint", "experiment",
                     "eval", "train", "evaluate", "serve.__main__",
                     "serve.fleet"))


def test_the_checkpoint_slice_has_its_pieces():
    """Checkpoints, window streaming and the full-trace replay are the
    port's own code."""
    import importlib
    sys.path.insert(0, ROOT)
    try:
        for mod, names in {
                "checkpoint": ("Checkpointer", "CheckpointRestoreError",
                               "CheckpointChecksumError",
                               "write_checksum_sidecar", "_crc32_file"),
                "experiment": ("drain_window", "make_env_windows",
                               "load_source_trace", "restore_policy"),
                "eval": ("full_trace_replay", "full_trace_report"),
                "select_checkpoint": ("build_parser", "main")}.items():
            m = importlib.import_module(f"rlgpuschedule_tpu_torch.{mod}")
            for n in names:
                assert getattr(m, n).__module__ == m.__name__, (mod, n)
    finally:
        sys.path.remove(ROOT)


def test_importing_the_async_path_leaves_jax_out():
    _leaves_jax_out(("async_engine", "parallel.groups", "obs.telemetry",
                     "train", "bench", "profile_breakdown"))


def test_unported_messages_name_open_roadmap_items():
    """Every ``item N`` a refusal of the port names is an open item of
    ``ROADMAP.md`` (one with its own entry in queue 1, a numbered line
    that opens ``N. **Item K``), so no message sends a user to a slice
    that has landed or does not exist."""
    import re
    roadmap = open(os.path.join(ROOT, "ROADMAP.md"),
                   encoding="utf-8").read()
    open_items = {int(n) for n in re.findall(r"^\d+\. \*\*Item (\d+)",
                                             roadmap, re.M)}
    named = set()
    for path in _port_files():
        text = open(path, encoding="utf-8").read()
        named |= {int(n) for n in re.findall(r"item (\d+)", text)}
    assert named and named <= open_items, sorted(named - open_items)


def test_importing_the_config_three_and_bench_path_leaves_jax_out():
    _leaves_jax_out(("algos.a2c", "algos.vtrace", "bench", "configs",
                     "env.rewards", "eval", "evaluate", "train"))


def test_the_config_three_slice_has_its_pieces():
    """A2C, V-trace, the reward options, the fairness reward and table,
    the mode table and the bench are the port's own code."""
    import importlib
    sys.path.insert(0, ROOT)
    try:
        for mod, names in {
                "algos.a2c": ("A2CConfig", "A2CMetrics", "make_optimizer",
                              "a2c_loss", "make_a2c_grad_step",
                              "run_a2c_update", "make_learn_step",
                              "make_train_step", "make_train_state"),
                "algos.vtrace": ("importance_ratios", "compute_vtrace"),
                "algos.ppo": ("ClippedRMSprop", "RewardNormState",
                              "init_reward_stats", "update_reward_stats",
                              "reward_scale", "loss_and_backward"),
                "algos.update": ("cast_floating",),
                "env.rewards": ("tenant_counts", "reward_fair"),
                "eval": ("jain_index", "fairness_report",
                         "format_fairness"),
                "configs": ("ModeCombinationError",
                            "validate_mode_combination"),
                "bench": ("build_parser", "geometry_from_sweep",
                          "central_spread", "main")}.items():
            m = importlib.import_module(f"rlgpuschedule_tpu_torch.{mod}")
            for n in names:
                assert getattr(m, n).__module__ == m.__name__, (mod, n)
    finally:
        sys.path.remove(ROOT)


def test_the_mode_table_is_jaxs():
    """The port's refusal table is the JAX package's, pair for pair and
    word for word, so a refused combination reads the same in both."""
    from rlgpuschedule_tpu import configs as jconfigs
    from rlgpuschedule_tpu_torch import configs as tconfigs
    assert tconfigs.MODE_FLAGS == jconfigs.MODE_FLAGS
    assert tconfigs.MODE_REFUSALS == jconfigs.MODE_REFUSALS
    with pytest.raises(KeyError):
        tconfigs.validate_mode_combination({"bogus": True})


def test_importing_the_config_five_path_leaves_jax_out():
    _leaves_jax_out(("env.hier", "models.hier", "parallel",
                     "parallel.population", "parallel.pbt", "experiment",
                     "train", "evaluate", "serve.fleet"))


def test_the_config_five_slice_has_its_pieces():
    """The hierarchical env and policy, the population and the PBT
    controller are the port's own code."""
    import importlib
    sys.path.insert(0, ROOT)
    try:
        names = {os.path.relpath(p, ROOT) for p in _port_files()}
        for f in ("env/hier.py", "models/hier.py", "parallel/__init__.py",
                  "parallel/population.py", "parallel/pbt.py"):
            assert f"rlgpuschedule_tpu_torch/{f}" in names, f
        for mod, names in {
                "env.hier": ("HierParams", "HierState", "pod_init",
                             "head_unassigned", "apply_route", "pod_place",
                             "next_event_time", "advance_all",
                             "forced_progress", "build_obs", "action_mask",
                             "reset", "step", "vec_reset", "vec_step",
                             "jct_stats", "validate_hier_trace"),
                "models.hier": ("HierActorCritic", "make_hier_policy"),
                "models.convert": ("member_params",),
                "parallel.population": ("HParams", "MemberState",
                                        "init_member", "sample_hparams",
                                        "make_member_learn_step",
                                        "make_member_step",
                                        "stack_members"),
                "parallel.pbt": ("PBTConfig", "PBTDecision",
                                 "PBTController", "exploit_explore",
                                 "gather_members"),
                "experiment": ("PopulationExperiment", "build_hier_params"),
                "train": ("FittestMemberView",)}.items():
            m = importlib.import_module(f"rlgpuschedule_tpu_torch.{mod}")
            for n in names:
                assert getattr(m, n).__module__ == m.__name__, (mod, n)
    finally:
        sys.path.remove(ROOT)


def test_importing_the_router_and_chaos_path_leaves_jax_out():
    _leaves_jax_out(("serve.router", "serve.bench", "serve.batching",
                     "serve.engine", "serve.__main__", "traces.fit",
                     "tree", "device"))


def test_the_router_slice_has_its_pieces():
    """The router, its fault injector and advisor, the chaos soak's
    trace fit and the tree helper are the port's own code."""
    import importlib
    sys.path.insert(0, ROOT)
    try:
        names = {os.path.relpath(p, ROOT) for p in _port_files()}
        for f in ("serve/router.py", "traces/fit.py", "tree.py"):
            assert f"rlgpuschedule_tpu_torch/{f}" in names, f
        for mod, names in {
                "serve.router": ("InjectedEngineFault", "ServeFaultSpec",
                                 "parse_serve_fault", "ServeFaultInjector",
                                 "EngineStats", "EngineRouter",
                                 "AutoscaleAdvisor"),
                "serve.bench": ("run_scaleout", "run_soak",
                                "fit_paced_gaps", "_rss_bytes",
                                "run_chaos_soak"),
                "traces.fit": ("TraceFit", "fit_hourly_curve", "fit_jobs",
                               "domain_fit", "gen_domain_window"),
                "tree": ("tree_map", "leaves", "structure", "unflatten",
                         "stack", "index"),
                "device": ("serve_devices",)}.items():
            m = importlib.import_module(f"rlgpuschedule_tpu_torch.{mod}")
            for n in names:
                assert getattr(m, n).__module__ == m.__name__, (mod, n)
    finally:
        sys.path.remove(ROOT)


def test_importing_the_chaos_and_domain_path_leaves_jax_out():
    _leaves_jax_out(("sim.faults", "domains", "domains.schedule",
                     "sim.oracle", "sim.schedulers", "eval", "evaluate",
                     "serve.fleet", "train"))


def test_the_chaos_and_domain_slice_has_its_pieces():
    """The fault process, the domain draws, the health and geometry
    channels, the chaos and generalization matrices and the domain
    windows are the port's own code."""
    import importlib
    sys.path.insert(0, ROOT)
    try:
        names = {os.path.relpath(p, ROOT) for p in _port_files()}
        for f in ("sim/faults.py", "domains/__init__.py",
                  "domains/schedule.py"):
            assert f"rlgpuschedule_tpu_torch/{f}" in names, f
        for mod, names in {
                "sim.faults": ("FaultSchedule", "no_faults", "node_up",
                               "next_transition", "job_stretch",
                               "effective_free", "validate_fault_schedule",
                               "fault_schedule_from_events", "FaultRegime",
                               "resolve_regime", "sample_fault_schedule",
                               "sample_env_fault_schedules",
                               "stack_fault_schedules", "schedule_stats",
                               "fault_horizon"),
                "domains.schedule": ("DomainSchedule", "DomainSpec",
                                     "resolve_domain", "DomainDraw",
                                     "sample_domain", "sample_env_domains",
                                     "domain_schedule",
                                     "validate_domain_schedule",
                                     "stack_domain_schedules",
                                     "domain_stats"),
                "sim.core": ("_kill_drained",),
                "env.obs": ("node_health", "node_geometry"),
                "eval": ("chaos_report", "format_chaos", "matrix_report",
                         "format_matrix", "_chaos_conservation",
                         "_shift_schedule"),
                "experiment": ("make_domain_windows", "draw_schedules"),
                "serve.fleet": ("sample_fleet_faults",)}.items():
            m = importlib.import_module(f"rlgpuschedule_tpu_torch.{mod}")
            for n in names:
                assert getattr(m, n).__module__ == m.__name__, (mod, n)
    finally:
        sys.path.remove(ROOT)


def test_importing_the_front_door_and_post_mortem_leaves_jax_out():
    _leaves_jax_out(("serve.wire", "serve.frontend", "serve.bench",
                     "serve.__main__", "obs.skew", "obs.report",
                     "obs.trace"))


def test_the_front_door_and_post_mortem_slice_has_its_pieces():
    """The wire framing, the front door, the clock-skew merge, the
    post-mortem and the span readers are the port's own code."""
    import importlib
    sys.path.insert(0, ROOT)
    try:
        names = {os.path.relpath(p, ROOT) for p in _port_files()}
        for f in ("serve/wire.py", "serve/frontend.py", "obs/skew.py",
                  "obs/report.py"):
            assert f"rlgpuschedule_tpu_torch/{f}" in names, f
        for mod, names in {
                "serve.wire": ("WireError", "descriptor", "pack_frame",
                               "unpack_prefix", "pack_request",
                               "pack_response", "pack_error", "recv_frame",
                               "unpack_action"),
                "serve.frontend": ("ServeFrontend", "FrontendHandle",
                                   "start_frontend"),
                "serve.bench": ("_run_wire_arm", "run_host_path"),
                "serve.__main__": ("_frontend_selfcheck",),
                "obs.skew": ("stamp", "RankSkew", "learn_offsets",
                             "correct_events", "merge_dir_corrected"),
                "obs.report": ("build_report", "build_request_report",
                               "format_request_report", "format_report",
                               "main"),
                "obs.trace": ("tracer_of", "build_span_tree",
                              "async_overlap_summary",
                              "to_chrome_trace")}.items():
            m = importlib.import_module(f"rlgpuschedule_tpu_torch.{mod}")
            for n in names:
                assert getattr(m, n).__module__ == m.__name__, (mod, n)
        from rlgpuschedule_tpu_torch.serve import PolicyServer
        assert callable(PolicyServer.queue_depth)
    finally:
        sys.path.remove(ROOT)


def test_importing_the_flywheel_leaves_jax_out():
    _leaves_jax_out(("flywheel", "flywheel.flightlog", "flywheel.canary",
                     "flywheel.continual", "obs.report", "train"))


def test_the_flywheel_slice_has_its_pieces():
    """The flight log, the canary and the continual loop are the port's
    own code, with the JAX package's public names."""
    import importlib
    sys.path.insert(0, ROOT)
    try:
        names = {os.path.relpath(p, ROOT) for p in _port_files()}
        for f in ("__init__", "flightlog", "canary", "continual"):
            assert f"rlgpuschedule_tpu_torch/flywheel/{f}.py" in names, f
        fly = importlib.import_module("rlgpuschedule_tpu_torch.flywheel")
        from rlgpuschedule_tpu import flywheel as jfly
        assert sorted(fly.__all__) == sorted(jfly.__all__)
        for n in fly.__all__:
            assert getattr(fly, n).__module__.startswith(
                "rlgpuschedule_tpu_torch.flywheel."), n
        decision = importlib.import_module(
            "rlgpuschedule_tpu_torch.decision")
        assert decision.policy_decision_full.__module__ == decision.__name__
    finally:
        sys.path.remove(ROOT)
