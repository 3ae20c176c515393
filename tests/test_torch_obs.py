"""The port's telemetry (``obs/``) held against the JAX package's on the
CPU.

- The same sequence of registry calls renders byte-equal Prometheus text
  in both packages; the same sink calls give events with equal names,
  keys and values (``ts``, ``wall`` and ``run_id`` aside), and the same
  nested spans the same nesting.
- ``Telemetry`` gates events and the exposition file to the chief; the
  file is written atomically; a torn last line is skipped.
- The training CLI with ``--telemetry-dir``: the port's and the JAX
  trainer's runs of the same flags give the same event names in the same
  order with the same keys, and equal ``train_steps_total`` and
  ``train_samples_total`` (losses are not compared: the dropout streams
  differ).  The JAX per-batch path's ``startup`` span and its ``compile``
  spans have no counterpart in the port, whose steps are not compiled;
  they are left out of the comparison.  The JAX trainer is run with its
  compiled-call fast path at its own documented fallback (the compiled
  object), since the installed jax refuses the fast path's call.
- The flag leaves the printed lines byte for byte as they are; the fused
  path counts steps and samples from its one host read an epoch.
- World formation writes ``rendezvous``/``rendezvous_retry`` events where
  the launcher exported ``ELASTIC_TELEMETRY_DIR``.
"""

from __future__ import annotations

import contextlib
import io
import os
import pathlib
import struct

import jax
import pytest
import torch

import mnist as jax_cli
from pytorch_mnist_ddp_tpu import obs as jax_obs
from pytorch_mnist_ddp_tpu.compile import program as jax_program
from pytorch_mnist_ddp_tpu.parallel.distributed import DistState as JaxDistState
from pytorch_mnist_ddp_tpu.trainer import fit as jax_fit
from pytorch_mnist_ddp_tpu_torch import obs
from pytorch_mnist_ddp_tpu_torch.data.mnist import _FILES, synthetic_mnist
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
from pytorch_mnist_ddp_tpu_torch.parallel import distributed as port_dist
from pytorch_mnist_ddp_tpu_torch.trainer import fit

torch.set_num_threads(1)
TIMING = {"ts", "wall", "run_id", "duration_s"}
LIMIT = 320  # 5 batches of 64 an epoch


def _drive_registry(registry) -> None:
    """One scripted sequence of registry calls (names, labels, help
    strings, escapes, integer and float values, empty and full
    reservoirs)."""
    registry.counter("train_steps_total", help="optimizer steps executed").inc(3)
    registry.counter("train_steps_total", help="optimizer steps executed").inc()
    registry.counter("train_samples_total", help="global training samples consumed").inc(192)
    registry.counter("data_retries_total", help="transient input-pipeline faults retried",
                     pipeline="train").inc()
    registry.counter("data_retries_total", pipeline="eval").inc(2)
    registry.counter("train_anomalies_total", help="by kind", kind="nan").inc()
    registry.counter("rank_deaths_total", help="rank processes that died\nor hung",
                     rank=1).inc()
    registry.gauge("test_accuracy", help="accuracy of the latest eval pass").set(0.9375)
    registry.gauge("train_samples_per_second", help="throughput").set(1234.5678)
    registry.gauge("rank_heartbeat_age_seconds", rank='a"b\\c\nd').set(2)
    hist = registry.histogram("train_step_latency_seconds", help="latency")
    for v in (0.003, 0.001, 0.25, 0.002, 1e-9, 7.0):
        hist.observe(v)
    registry.histogram("checkpoint_write_seconds", help="write + publish")  # empty
    registry.histogram("span_duration_seconds", help="spans", span="run").observe(2.5)


def test_registry_calls_render_byte_equal_prometheus_text():
    port, ref = obs.Registry(), jax_obs.Registry()
    _drive_registry(port)
    _drive_registry(ref)
    text = obs.render_prometheus(port)
    assert text == jax_obs.render_prometheus(ref)
    assert 'rank_heartbeat_age_seconds{rank="a\\"b\\\\c\\nd"} 2' in text
    assert "# HELP rank_deaths_total rank processes that died\\nor hung" in text


def test_write_prometheus_is_atomic_and_equal_to_the_render(tmp_path):
    registry = obs.Registry()
    _drive_registry(registry)
    path = tmp_path / "metrics.prom"
    obs.write_prometheus(registry, str(path))
    assert path.read_text() == obs.render_prometheus(registry)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["metrics.prom"]


def _drive_events(module, directory: str) -> list[dict]:
    """The same emits and nested spans through ``module``'s sink; returns
    the records as read back."""
    sink = module.EventSink(directory, rank=0)
    registry = module.Registry()
    sink.emit("step", epoch=1, step=0, loss=2.302585, latency_s=0.01, samples=64)
    with module.span("run", sink=sink, registry=registry):
        assert module.current_span() == "run"
        with module.span("epoch", sink=sink, registry=registry, epoch=1):
            with module.span("evaluate", sink=sink, registry=registry):
                assert module.current_span() == "evaluate"
            with pytest.raises(KeyError):
                with module.span("broken", sink=sink, registry=registry, epoch=1):
                    raise KeyError("x")
        sink.emit("eval", epoch=1, avg_loss=0.5, correct=9, accuracy=0.9)
    assert module.current_span() is None
    sink.emit("run_complete", wall_seconds=1.0)
    sink.close()
    sink.emit("late", x=1)  # after close: dropped
    [(name, _, _, children)] = registry.collect()
    assert name == "span_duration_seconds"
    assert {labels["span"]: m.count for labels, m in children} == {
        "run": 1, "epoch": 1, "evaluate": 1, "broken": 1}
    return module.read_events(sink.path)


def test_events_and_span_nesting_equal_jax(tmp_path):
    port = _drive_events(obs, str(tmp_path / "port"))
    ref = _drive_events(jax_obs, str(tmp_path / "jax"))
    strip = lambda ev: [{k: v for k, v in e.items() if k not in TIMING} for e in ev]  # noqa: E731
    assert strip(port) == strip(ref)
    assert [(e.get("span"), e.get("parent"), e.get("depth")) for e in port
            if e["event"].startswith("span_")] == [
        ("run", None, 0), ("epoch", "run", 1), ("evaluate", "epoch", 2),
        ("evaluate", "epoch", 2), ("broken", "epoch", 2), ("broken", "epoch", 2),
        ("epoch", "run", 1), ("run", None, 0)]
    assert all(e["duration_s"] >= 0 for e in port if e["event"] == "span_end")
    assert len({e["run_id"] for e in port}) == 1 and all(e["rank"] == 0 for e in port)
    assert [k for k in port[0]][:5] == ["ts", "wall", "run_id", "rank", "event"]


def test_read_events_skips_a_torn_last_line(tmp_path):
    sink = obs.EventSink(str(tmp_path), rank=2)
    sink.emit("step", step=0)
    sink.close()
    with open(sink.path, "a") as f:
        f.write('\n{"event": "step", "st')
    assert [e["event"] for e in obs.read_events(sink.path)] == ["step"]
    assert pathlib.Path(sink.path).name == "events-rank2.jsonl"


@pytest.mark.parametrize("rank,distributed,writes", [(0, False, True), (0, True, True),
                                                      (1, True, False), (1, False, True)])
def test_telemetry_gates_events_and_the_file_to_the_chief(tmp_path, rank, distributed, writes):
    port = obs.Telemetry(str(tmp_path / "p"), rank=rank, distributed=distributed)
    ref = jax_obs.Telemetry(str(tmp_path / "j"), rank=rank, distributed=distributed)
    assert bool(port.events) == bool(ref.events) == writes
    port.registry.counter("train_steps_total").inc()
    with port.span("run"):
        pass
    path = port.write_exposition()
    assert (path is not None) == writes == (ref.write_exposition() is not None)
    if writes:
        assert pathlib.Path(path).read_text() == obs.render_prometheus(port.registry)
    port.close()
    ref.close()


def test_a_span_with_trace_dir_writes_the_profilers_trace(tmp_path):
    with obs.span("profiled", trace_dir=str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1


# -- the training CLI -----------------------------------------------------------

@pytest.fixture(scope="module")
def idx_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    for split, n in (("train", LIMIT), ("test", LIMIT)):
        images, labels = synthetic_mnist(split, n)
        (root / _FILES[(split, "images")]).write_bytes(
            struct.pack(">iiii", 2051, n, 28, 28) + images.tobytes())
        (root / _FILES[(split, "labels")]).write_bytes(
            struct.pack(">ii", 2049, n) + labels.tobytes())
    return root


@pytest.fixture(autouse=True)
def _idx_dir(monkeypatch, idx_root):
    monkeypatch.setenv("MNIST_DATA_DIR", str(idx_root))


FLAGS = ["--epochs", "2", "--train-limit", str(LIMIT), "--log-interval", "2"]


def _port_run(*flags) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fit(build_parser().parse_args([*FLAGS, *flags]), "cpu")
    return out.getvalue()


def _events(directory) -> list[dict]:
    return obs.read_events(str(pathlib.Path(directory) / "events-rank0.jsonl"))


def _counters(directory) -> dict[str, str]:
    lines = (pathlib.Path(directory) / "metrics.prom").read_text().splitlines()
    return dict(ln.split(" ", 1) for ln in lines if ln.startswith(("train_steps_total ",
                                                                   "train_samples_total ")))


def test_cli_telemetry_matches_the_jax_trainers_events(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_program, "compiled_fastpath", lambda compiled: compiled)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    args = jax_cli.build_parser().parse_args([*FLAGS, "--telemetry-dir", str(jax_dir)])
    with contextlib.redirect_stdout(io.StringIO()):
        jax_fit(args, JaxDistState(devices=jax.devices()[:1]))
    flagless = _port_run()
    assert _port_run("--telemetry-dir", str(port_dir)) == flagless

    def shape(ev):
        return [(e["event"], e.get("span"), sorted(set(e) - TIMING)) for e in ev
                if e.get("span") not in ("startup", "compile")]

    port, ref = _events(port_dir), _events(jax_dir)
    assert shape(port) == shape(ref)
    assert [e["event"] for e in port].count("step") == 10
    assert [(e["epoch"], e["step"], e["samples"]) for e in port if e["event"] == "step"] == [
        (e["epoch"], e["step"], e["samples"]) for e in ref if e["event"] == "step"]
    assert _counters(port_dir) == _counters(jax_dir) == {
        "train_steps_total": "10", "train_samples_total": "640"}
    prom = (port_dir / "metrics.prom").read_text()
    for name in ("train_step_latency_seconds_count 10", "test_accuracy ",
                 "train_samples_per_second ", 'span_duration_seconds_count{span="epoch"} 2',
                 'data_wait_seconds_count{pipeline="train"} 10'):
        assert name in prom, name


def test_fused_path_counts_from_its_one_read_an_epoch(tmp_path):
    timings: dict = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fit(build_parser().parse_args([*FLAGS, "--fused", "--pallas-opt", "--telemetry-dir",
                                       str(tmp_path)]), "cpu", timings=timings)
    assert timings["host_syncs"] == 2
    assert _counters(tmp_path) == {"train_steps_total": "10", "train_samples_total": "640"}
    names = [e["event"] for e in _events(tmp_path)]
    assert names == ["span_start", "eval", "eval", "span_end", "run_complete"]
    assert out.getvalue().count("Test set:") == 2


def test_rendezvous_events_land_in_the_launchers_dir(tmp_path, monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "MASTER_ADDR",
                 "MASTER_PORT", "RDZV_TIMEOUT_S", "RDZV_ATTEMPTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ELASTIC_TELEMETRY_DIR", str(tmp_path / "tel"))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        state = port_dist.form_world(f"file://{tmp_path / 'rdzv'}", 20, device="cpu")
    finally:
        port_dist.destroy_distributed()
    assert state.rendezvous_attempts == 1
    [ev] = obs.read_events(str(tmp_path / "tel" / "events-rdzv-rank0.jsonl"))
    assert {k: ev[k] for k in ("event", "attempts", "ok", "rank", "world")} == {
        "event": "rendezvous", "attempts": 1, "ok": True, "rank": 0, "world": 1}
    # a peer that never comes: one retry event, then the failed rendezvous
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RDZV_TIMEOUT_S", "2")
    with pytest.raises(RuntimeError, match="a peer never arrived"):
        port_dist.form_world(f"file://{tmp_path / 'rdzv2'}", device="cpu")
    events = obs.read_events(str(tmp_path / "tel" / "events-rdzv-rank0.jsonl"))[1:]
    assert [(e["event"], e.get("attempt"), e.get("ok")) for e in events] == [
        ("rendezvous_retry", 1, None), ("rendezvous", None, False)]
    assert os.path.exists(tmp_path / "tel")
