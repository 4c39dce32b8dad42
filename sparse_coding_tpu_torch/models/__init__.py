"""Trainable signatures and inference dictionaries (tied, untied and
masked-tied SAEs)."""

from sparse_coding_tpu_torch.models import learned_dict, sae, signatures  # noqa: F401
