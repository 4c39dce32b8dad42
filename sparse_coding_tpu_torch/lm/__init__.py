"""Language models for harvesting activations (the JAX package's ``lm/``):
GPT-NeoX (Pythia) and GPT-2 forwards with activation taps and in-flight
edits, their presets, conversion from Hugging Face state dicts, and the
sequence-parallel GPT-NeoX forward over a mesh (``long_context.py``, with
``ring_attention.py``) for contexts longer than one forward holds."""
