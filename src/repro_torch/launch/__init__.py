"""Entry points and step factories of the token-LM train path:
``steps.py`` (train / prefill / decode steps, ``batch_shapes``),
``mesh.py`` (the production and host device meshes) and ``train.py``
(``python -m repro_torch.launch.train``)."""
