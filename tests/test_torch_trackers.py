"""The port's trackers (``utils/trackers.py``), metrics registry
(``observability/metrics.py``), profiler window
(``observability/profiling.py``) and logging (``utils/logging.py``)
against the JAX package's, on the CPU:

- the JSONL records of the same stats equal JAX's, the ``time`` field
  aside, and so does the ``config.json`` beside them;
- ``make_tracker`` picks the same tracker for every ``train.tracker`` and
  directory setting, falls back to JSONL where a package is missing (W&B
  is missing here; TensorBoard is made missing), and refuses the same
  names;
- ``parse_profile_spec`` parses and rejects as JAX's does, and a window
  writes one Chrome trace of its steps;
- the registry's snapshot equals JAX's for the same counter and gauge
  writes;
- the logger takes its level from ``TRLX_TPU_VERBOSITY`` and keeps a
  record to the ranks it names.
"""

import json
import logging
import os
import sys

import pytest
import torch

from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
from trlx_tpu.observability.metrics import MetricsRegistry as JaxMetricsRegistry
from trlx_tpu.observability.profiling import parse_profile_spec as jax_parse_profile_spec
from trlx_tpu.utils import trackers as jax_trackers
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.observability.metrics import MetricsRegistry
from trlx_tpu_torch.observability.profiling import (
    ProfileWindow,
    default_profile_dir,
    parse_profile_spec,
)
from trlx_tpu_torch.utils import logging as port_logging
from trlx_tpu_torch.utils import trackers
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

STATS = [
    {"losses/total_loss": 0.123456, "learning_rate": 3e-5, "time/step": 0.25, "count": 7,
     "flag": True, "skip/me": "text", "array": [1.0, 2.0], "nan": float("nan"),
     "tensor": torch.tensor(2.5), "big": 123456789.0, "neg": -0.000123456},
    {"reward/mean": 0.5},
    {},
]


def _records(path):
    out = []
    with open(path) as f:
        for line in f:
            record = json.loads(line)
            record.pop("time")
            out.append(record)
    return out


def _jax_stats(stats):
    return {k: (float(v) if isinstance(v, torch.Tensor) else v) for k, v in stats.items()}


def test_jsonl_records_match_jax(tmp_path):
    config = default_ppo_config().to_dict()
    ours = trackers.JSONLTracker(str(tmp_path / "port"), config)
    theirs = jax_trackers.JSONLTracker(str(tmp_path / "jax"), jax_default_ppo_config().to_dict())
    for step, stats in enumerate(STATS):
        ours.log(stats, step=step)
        theirs.log(_jax_stats(stats), step=step)
    ours.finish()
    theirs.finish()
    got, want = _records(ours.path), _records(theirs.path)
    assert json.dumps(got) == json.dumps(want)
    assert [s for s, _ in ours.history] == [0, 1, 2]
    for name in ("config.json",):
        with open(tmp_path / "port" / name) as f, open(tmp_path / "jax" / name) as g:
            assert json.load(f) == json.load(g)
    # a log after finish reopens the file, in both
    ours.log({"a": 1.0}, step=3)
    theirs.log({"a": 1.0}, step=3)
    ours.finish()
    theirs.finish()
    assert _records(ours.path) == _records(theirs.path)


def _config_dicts(tmp_path, tracker, logging_dir, checkpoint_dir):
    dicts = []
    for make in (default_ppo_config, jax_default_ppo_config):
        d = make().to_dict()
        d["train"].update(tracker=tracker, logging_dir=logging_dir, checkpoint_dir=checkpoint_dir)
        dicts.append(d)
    return dicts


def _kind(tracker_obj, root):
    path = getattr(tracker_obj, "path", None)
    return type(tracker_obj).__name__, path and os.path.relpath(path, root)


@pytest.mark.parametrize("tracker,logging_dir,checkpoint_dir", [
    (None, None, "ckpt"),
    (None, "logs_here", "ckpt"),
    (None, None, None),
    ("jsonl", None, "ckpt"),
    ("tensorboard", "tb", "ckpt"),
    ("wandb", None, "ckpt"),
])
def test_make_tracker_matches_jax(tmp_path, monkeypatch, tracker, logging_dir, checkpoint_dir):
    from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
    from trlx_tpu_torch.data.configs import TRLConfig

    monkeypatch.chdir(tmp_path)
    ours_d, theirs_d = _config_dicts(tmp_path, tracker, logging_dir, checkpoint_dir)
    ours = trackers.make_tracker(TRLConfig.from_dict(ours_d))
    if checkpoint_dir is None:
        # JAX's make_tracker documents the null tracker here but joins the
        # missing checkpoint directory first and raises
        with pytest.raises(TypeError):
            jax_trackers.make_tracker(JaxTRLConfig.from_dict(theirs_d))
        assert _kind(ours, tmp_path) == ("Tracker", None)
        return
    theirs = jax_trackers.make_tracker(JaxTRLConfig.from_dict(theirs_d))
    assert _kind(ours, tmp_path) == _kind(theirs, tmp_path)
    ours.finish()
    theirs.finish()


def test_missing_package_falls_back_to_jsonl(tmp_path, monkeypatch, caplog):
    """No ``wandb`` here; ``torch.utils.tensorboard`` made missing: both
    packages warn and write JSONL into the logging directory."""
    from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
    from trlx_tpu_torch.data.configs import TRLConfig

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    for name in ("tensorboard", "wandb"):
        ours_d, theirs_d = _config_dicts(tmp_path, name, "logs", "ckpt")
        with caplog.at_level(logging.WARNING):
            ours = trackers.make_tracker(TRLConfig.from_dict(ours_d))
        assert any(f"tracker '{name}' unavailable" in r.getMessage() for r in caplog.records)
        theirs = jax_trackers.make_tracker(JaxTRLConfig.from_dict(theirs_d))
        assert _kind(ours, tmp_path) == _kind(theirs, tmp_path) == (
            "JSONLTracker", os.path.join("logs", "stats.jsonl"))
        ours.log({"x": 1.0}, step=1)
        ours.finish()
        theirs.finish()
    with pytest.raises(ValueError, match="Unknown tracker 'mlflow'"):
        ours_d, _ = _config_dicts(tmp_path, "mlflow", "logs", "ckpt")
        trackers.make_tracker(TRLConfig.from_dict(ours_d))


def test_tensorboard_tracker_writes_events(tmp_path):
    pytest.importorskip("tensorboard")
    tb = trackers.TensorBoardTracker(str(tmp_path), default_ppo_config().to_dict())
    tb.log({"losses/total_loss": 0.5, "note": "x"}, step=1)
    tb.finish()
    assert any(name.startswith("events.out.tfevents") for name in os.listdir(tmp_path))
    assert tb.history == [(1, {"losses/total_loss": 0.5, "note": "x"})]


@pytest.mark.parametrize("spec", [
    "steps:3-5,dir:/x/y", "steps:4", "dir:/z, steps:1-1", " steps:2-9 ,", "steps:5-3",
    "steps:a-b", "dir:/only", "steps:1-2,speed:3", "", "steps:",
])
def test_parse_profile_spec_matches_jax(spec):
    def parse(fn):
        try:
            return fn(spec)
        except ValueError:
            return "ValueError"

    ours, theirs = parse(parse_profile_spec), parse(jax_parse_profile_spec)
    if "dir:" not in spec and ours != "ValueError":
        # the default directory is each package's own temporary one
        assert ours[2] == default_profile_dir()
        ours, theirs = ours[:2], theirs[:2]
    assert ours == theirs


def test_profile_window_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("TRLX_TPU_PROFILE", f"steps:1-2,dir:{tmp_path}")
    window = ProfileWindow.from_env()
    x = torch.randn(16, 16)
    for step in range(4):
        window.on_step_start(step)
        with window.step_annotation("train", step):
            x = torch.tanh(x @ x)
        window.on_step_end(step)
    window.stop()
    assert window.trace_path == str(tmp_path / "trace_steps1-2.json")
    with open(window.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train#1", "train#2"} <= names and "train#0" not in names
    monkeypatch.setenv("TRLX_TPU_PROFILE", "steps:9-1")
    assert not ProfileWindow.from_env().enabled


def test_metrics_registry_matches_jax():
    ours, theirs = MetricsRegistry(), JaxMetricsRegistry()
    for registry in (ours, theirs):
        registry.inc("resilience/reward_retries")
        registry.inc("resilience/reward_retries", 2.0)
        registry.set_gauge("resilience/goodput_frac", 0.75)
        registry.set_gauge("resilience/goodput_frac", 0.5)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.counter("resilience/reward_retries") == 3.0


def test_logger_level_from_env_and_rank_gating(monkeypatch, caplog):
    monkeypatch.setenv("TRLX_TPU_VERBOSITY", "error")
    assert port_logging.level_from_env() == logging.ERROR
    monkeypatch.setenv("TRLX_TPU_VERBOSITY", "loud")
    assert port_logging.level_from_env(logging.INFO) == logging.INFO
    log = port_logging.get_logger("trlx_tpu_torch.test_gating")
    with caplog.at_level(logging.INFO, logger="trlx_tpu_torch.test_gating"):
        monkeypatch.setenv("RANK", "1")
        log.info("hidden on rank 1")
        log.info("shown everywhere", ranks=[-1])
        monkeypatch.setenv("RANK", "0")
        log.info("shown on rank 0")
    messages = [r.getMessage() for r in caplog.records if r.name == log.logger.name]
    assert messages == ["[RANK 1] shown everywhere", "[RANK 0] shown on rank 0"]
