"""Operator tools over the port's serving stack (the JAX package's
``tools/serve_loadgen.py`` and ``tools/slo_gate.py``):

- ``python -m pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen``: the load
  generator (closed and open loop, QoS mixes, hedging, the tail, host-path
  and device-path A/Bs, chaos, replica and fleet sweeps, the registry
  rounds);
- ``python -m pytorch_mnist_ddp_tpu_torch.tools.slo_gate``: the SLO gate,
  which replays ``slo_budgets.json``'s protocol through the load
  generator and checks its budget table;
- ``python -m pytorch_mnist_ddp_tpu_torch.tools.vit_bench``: one JSON row
  of a ViT CLI run (the JAX package's ``tools/vit_bench.py``): wall clock,
  accuracy, and for ``--fused`` the ``--timings-json`` attribution and MFU;
- ``.tools.train_chaos``: kill -> resume -> bit-exact with real trainer
  and launcher processes; ``.tools.trace_attr``: a torch.profiler Chrome
  trace distilled to a per-category, per-op table; ``.tools.step_attr_bench``:
  a ladder of CNN step variants, each one CUDA graph; ``.tools.perf_report``:
  the verdict over the ladders and the trace attribution under
  ``build/perf/``, and with ``--telemetry DIR`` the summary of a
  ``--telemetry-dir`` directory; ``.tools.window_promote``: the rules that
  keep a recorded ladder or row the best across runs (the JAX package's
  tools of the same names);
- ``.tools.sharded_bench``: the sharded structural pin (fake engines through
  the batcher and router) and the replica-shape sweep of real pools over
  one device (the JAX package's ``tools/sharded_bench.py``).

None imports torch at module level: ``serve_loadgen --url`` drives a
remote endpoint without it.
"""
