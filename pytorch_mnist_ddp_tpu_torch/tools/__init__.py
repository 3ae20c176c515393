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
  accuracy, and for ``--fused`` the ``--timings-json`` attribution and MFU.

None imports torch at module level: ``serve_loadgen --url`` drives a
remote endpoint without it.
"""
