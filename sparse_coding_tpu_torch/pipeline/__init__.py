"""The operations pipeline (the JAX package's ``pipeline/``). Only the
elastic plane's :class:`~sparse_coding_tpu_torch.pipeline.plane.Hysteresis`
is ported so far (the serving gateway's ladder flap guard); the rest of
the package is ROADMAP.md queue 1, item 14."""
