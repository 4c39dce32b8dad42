"""Language models for harvesting activations (the JAX package's ``lm/``):
GPT-NeoX (Pythia) and GPT-2 forwards with activation taps and in-flight
edits, their presets, and conversion from Hugging Face state dicts. The
sequence-parallel ``long_context.py`` and ``ring_attention.py`` are not
ported (ROADMAP queue 1, items 11 and 23)."""
