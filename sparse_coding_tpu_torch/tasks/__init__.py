"""Task datasets and task-feature identification (the JAX package's
``tasks/``)."""
