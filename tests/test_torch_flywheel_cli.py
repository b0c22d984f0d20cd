"""The data flywheel's loop through the port's CLIs, on the CPU at a cut
config 1 (2 x 4 GPUs, 16-job windows, queue 4): serve a soak into a
durable flight log, retrain on it with ``train --continual``, block a
regressed candidate, promote the retrained one and roll it back on an
injected SLO fault, then find one logged request with the post-mortem.

- ``serve --soak --flight-log --durable-log`` (a subprocess, as a user
  runs it): ``rows_logged == served``, crc-verified on reload, the seal
  events and the two counters in the scrape.
- ``train --continual LOGDIR --ckpt-dir``: every shard admitted, the
  learner stepped, the gauges and counters exported.
- ``serve --promote-noise 0.5``: blocked by the canary.
- ``serve --promote CKPT --promote-fault --canary-tol 0.3``: the
  retrained candidate, which decides some logged rows otherwise, is
  promoted with 0 swap recompiles, rolled back, and the probe's
  decisions come back bit for bit. (The seeded policy head is near
  zero, so its top-two logits sit close, and a log whose rows nearly all
  met their deadlines rewards every action alike: the retrain's Adam
  updates reorder the seeded logits in a direction the log does not pin
  and move more than the default 2 % of a slice. The operator's looser
  tolerance is what promotes it.)
- The ledger reads ``blocked, promote, rollback``, all sealed; ``obs.report
  --request ID --flight-log`` finds the row and the verdicts, and the
  flywheel's events raise no alarm.
- The flags' silent no-ops are refused with JAX's words.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rlgpuschedule_tpu import train as jtrain
from rlgpuschedule_tpu.serve import __main__ as jserve
from rlgpuschedule_tpu_torch import train as ttrain
from rlgpuschedule_tpu_torch.flywheel import read_flight_log, read_ledger
from rlgpuschedule_tpu_torch.obs import merge_dir
from rlgpuschedule_tpu_torch.obs import report as treport
from rlgpuschedule_tpu_torch.serve import __main__ as tserve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = ["--config", "ppo-mlp-synth64", "--n-envs", "2", "--n-nodes", "2",
       "--gpus-per-node", "4", "--window-jobs", "16", "--queue-len", "4",
       "--horizon", "64", "--device", "cpu"]
SERVE = CUT + ["--bucket", "8", "--pool-steps", "8"]


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("flywheel"))
    flog, obs = os.path.join(d, "flog"), os.path.join(d, "obs_soak")
    p = subprocess.run(
        [sys.executable, "-m", "rlgpuschedule_tpu_torch.serve", *SERVE,
         "--soak", "2", "--rate", "120", "--deadline-ms", "250",
         "--flight-log", flog, "--flight-capacity", "32", "--durable-log",
         "--obs-dir", obs, "--trace-spans"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    soak = json.loads(p.stdout.strip().splitlines()[-1])
    ckpt = os.path.join(d, "ckpt")
    cont = ttrain.main(CUT + ["--continual", flog, "--iterations", "2",
                              "--n-steps", "8", "--n-epochs", "1",
                              "--n-minibatches", "2", "--ckpt-dir", ckpt])
    block = tserve.main(SERVE + ["--flight-log", flog, "--durable-log",
                                 "--promote-noise", "0.5"])
    promote = tserve.main(SERVE + ["--flight-log", flog, "--durable-log",
                                   "--promote", ckpt, "--promote-fault",
                                   "--canary-tol", "0.3"])
    return dict(dir=d, flog=flog, obs=obs, soak=soak, cont=cont,
                block=block["promote"], promote=promote["promote"],
                ckpt=ckpt)


def test_the_soak_logs_every_served_row(loop):
    s, fl = loop["soak"]["soak"], loop["soak"]["flight_log"]
    assert fl["conservation_ok"] and fl["durable"]
    assert fl["rows_logged"] == s["served"] > 0
    assert s["post_warmup_recompiles"] == 0 and s["dispatch_errors"] == 0
    data = read_flight_log(loop["flog"])
    assert not data.torn_tail and data.rows == fl["rows_logged"]
    assert len(data.shards) == fl["shards_sealed"]
    cat = data.concat()
    assert (cat.req_id != 0).all() and np.unique(cat.req_id).size == data.rows
    assert set(np.unique(cat.outcome)) <= {1, 2}   # every row had a deadline
    seals = [e for e in merge_dir(loop["obs"])
             if e["kind"] == "flywheel_shard_seal"]
    assert sum(e["rows"] for e in seals) == fl["rows_logged"]
    prom = open(os.path.join(loop["obs"], "metrics.prom")).read()
    for name in ("flywheel_rows_logged_total",
                 "flywheel_shards_sealed_total"):
        assert name in prom


def test_train_continual_admits_and_steps(loop):
    s = loop["cont"]
    assert s["mode"] == "continual" and s["device"] == "cpu"
    assert s["shards_seen"] == s["shards_accepted"] > 0
    assert s["shards_refused"] == 0 and not s["torn_tail"]
    assert s["rows_trained"] > 0 and s["final_step"] == 4
    assert all(abs(p["rho_mean"] - 1.0) < 1e-6 and p["staleness"] == 0
               for p in s["per_shard"])
    assert 0.5 < s["rho_mean_trained"] < 2.0
    assert np.isfinite(s["total_loss"])
    assert sorted(n for n in os.listdir(loop["ckpt"])
                  if n.isdigit()) == ["2", "4"]


def test_the_regressed_candidate_is_blocked(loop):
    b = loop["block"]
    assert b["verdict"] == "blocked" and not b["promoted"]
    assert b["canary"]["max_regress_streak"] >= 2
    assert b["canary"]["incumbent_agreement"] == 1.0
    assert b["candidate"].endswith("+noise(sigma=0.5,seed=0)")


def test_the_retrained_candidate_promotes_and_rolls_back(loop):
    p = loop["promote"]
    assert p["verdict"] == "promote" and p["promoted"]
    assert p["candidate"].endswith("ckpt@4")
    assert p["canary"]["candidate_agreement"] < 1.0   # it moved
    assert p["swap_recompiles"] == 0 and p["post_warmup_recompiles"] == 0
    assert p["rewarmed_buckets"] == [1, 2, 4, 8]
    assert p["rollback"] and p["probe_bit_identical"] is True
    assert any("p99" in r for r in p["rollback_reasons"])
    assert p["watchdog_ticks"][-1]["rollback"]


def test_the_ledger_and_the_post_mortem(loop, capsys):
    sealed, tail = read_ledger(loop["flog"])
    assert [e["action"] for e in sealed] == ["blocked", "promote",
                                             "rollback"]
    assert not tail and sealed[2]["bit_identical"] is True
    cat = read_flight_log(loop["flog"]).concat()
    rid = int(cat.req_id[len(cat.req_id) // 2])
    rc = treport.main([loop["obs"], "--request", hex(rid), "--flight-log",
                       loop["flog"], "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["found"]
    assert [s["stage"] for s in rep["stages"]] == ["enqueue", "served"]
    assert rep["flight"]["global_row"] == len(cat.req_id) // 2
    assert rep["flight"]["outcome_name"] in ("met", "served-late")
    assert [v["action"] for v in rep["verdicts"]] == ["blocked", "promote",
                                                      "rollback"]
    assert treport.main([loop["obs"], "--request", hex(rid),
                         "--flight-log", loop["flog"]]) == 0
    text = capsys.readouterr().out
    assert "logged: shard" in text and "replayed: ledger rollback" in text
    assert treport.main([loop["obs"], "--strict-alarms"]) == 0


def _exit(fn, argv):
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return str(e.value.code)


@pytest.mark.parametrize("argv", [
    ["--promote-noise", "0.5"],
    ["--flight-log", "d", "--bench"],
    ["--soak", "1", "--durable-log"],
    ["--soak", "1", "--flight-log", "d", "--flight-capacity", "0"],
    ["--promote-step", "3", "--bench"],
    ["--flight-log", "d", "--promote-noise", "-1"],
    ["--bench", "--promote-fault"],
    ["--flight-log", "d", "--promote-noise", "1", "--canary-slices", "0"],
    ["--flight-log", "d", "--promote-noise", "1", "--canary-tol", "-1"],
    ["--flight-log", "d", "--promote-noise", "1",
     "--canary-hysteresis", "0"]])
def test_serve_refuses_the_flywheels_no_ops_as_jax(argv):
    assert _exit(tserve.main, argv + ["--device", "cpu"]) == \
        _exit(jserve.main, argv)


@pytest.mark.parametrize("argv", [
    ["--continual-trust", "3"], ["--continual-rho-max", "4"],
    ["--continual", "x", "--continual-trust", "0.5"],
    ["--continual", "x", "--continual-rho-max", "0"],
    ["--continual", "x", "--pbt"],
    ["--config", "hier-pbt-member", "--continual", "x"]])
def test_train_refuses_the_continual_no_ops_as_jax(argv):
    assert _exit(ttrain.main, argv + ["--device", "cpu"]) == \
        _exit(jtrain.main, argv)
