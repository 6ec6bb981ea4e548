"""Plain fp32 references of what the benchmark's cells run.

``params`` and ``data`` work out a run's weights and rows again from its
seed; ``model`` is the forward pass of the dense GQA decoder and of the
Mamba2 hybrid with shared attention in plain PyTorch, every product in
fp32 with TF32 off; ``train`` follows a run's first steps (loss, clipped
gradient, AdamW).  ``model.Products`` switches every product to a lower
precision for the control.  Nothing here imports ``jax``, the JAX package
or anything of ``repro_torch``.
"""
