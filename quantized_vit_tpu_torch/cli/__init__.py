"""Command-line entry points (the JAX package's ``cli/``), chained as train ->
export -> serve, with evaluation and prediction of a checkpoint:

- ``python -m quantized_vit_tpu_torch.cli.train``  -- QAT + GETA pruning,
  then the compressed subnet (``<out-dir>/compressed``)
- ``python -m quantized_vit_tpu_torch.cli.eval``   -- test-set top-1 /
  top-5 of a checkpoint (full or compressed)
- ``python -m quantized_vit_tpu_torch.cli.predict`` -- single-image
  softmax top-k
- ``python -m quantized_vit_tpu_torch.cli.export vit`` -- a checkpoint
  (full or compressed) -> the integer serving artifact
- ``python -m quantized_vit_tpu_torch.cli.serve``  -- the artifact behind
  continuous batching

Each runs on the card unless ``--device cpu``.
"""
