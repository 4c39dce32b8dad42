"""Auto-interpretation of learned features (the JAX package's
``interp/``): the fragment dataset (:mod:`fragments`), the explainer
clients (:mod:`client`), the drivers and score readers (:mod:`run`) and
the ablation-graph and investigation drivers (:mod:`graph`)."""
