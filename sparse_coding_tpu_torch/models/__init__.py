"""Trainable signatures and inference dictionaries (tied and untied SAEs)."""

from sparse_coding_tpu_torch.models import learned_dict, sae, signatures  # noqa: F401
