"""``scripts/check_metric_names.py`` on the port: every ``stats[...]`` and
registry key in ``trlx_tpu_torch/`` follows the ``namespace/name``
convention, the scanner sees the observability slice's keys, and every
key of the observability families is one the JAX package writes too (the
port adds no metric of its own there)."""

import importlib.util
import os

import pytest

from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "trlx_tpu_torch")
JAX = os.path.join(REPO, "trlx_tpu")


def _checker():
    spec = importlib.util.spec_from_file_location(
        "check_metric_names", os.path.join(REPO, "scripts", "check_metric_names.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_metric_keys_are_namespaced():
    assert _checker().find_violations(PORT) == []


def test_scanner_sees_the_port_observability_keys():
    keys = _checker().scanned_keys(PORT)
    assert sum(keys.values()) >= 50
    for key in ("time/step", "time/train_step", "throughput/mfu",
                "throughput/flops_per_sec_per_device", "throughput/tokens_per_sec",
                "throughput/samples_per_sec", "cluster/straggler_rank", "cluster/size",
                "flightrec/dumps", "flightrec/records", "obs/spans_dropped",
                "health/triage_dumps", "health/kl_ctl_skips"):
        assert key in keys, key


@pytest.mark.parametrize("family", ["cluster/", "flightrec/", "obs/", "health/", "dist/",
                                    "throughput/", "memory/", "recompile/"])
def test_observability_keys_are_jax_keys(family):
    checker = _checker()
    port = {k for k in checker.scanned_keys(PORT) if k.startswith(family)}
    jax = {k for k in checker.scanned_keys(JAX) if k.startswith(family)}
    assert port <= jax, sorted(port - jax)
