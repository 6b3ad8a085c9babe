"""Command-line entry points (the JAX package's ``cli/``), chained as train ->
export -> serve:

- ``python -m quantized_vit_tpu_torch.cli.train``  -- QAT + GETA pruning,
  then the compressed subnet (``<out-dir>/compressed``)
- ``python -m quantized_vit_tpu_torch.cli.export vit`` -- a checkpoint
  (full or compressed) -> the integer serving artifact
- ``python -m quantized_vit_tpu_torch.cli.serve``  -- the artifact behind
  continuous batching

Each runs on the card unless ``--device cpu``. ``cli.eval`` and
``cli.predict`` are in ROADMAP.md, modules to port, 'Inference CLIs and
data'.
"""
