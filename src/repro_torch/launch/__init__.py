"""Entry points and step factories of the token-LM train path:
``steps.py`` (train / prefill / decode steps, ``batch_shapes``),
``mesh.py`` (the production and host device meshes), ``train.py``
(``python -m repro_torch.launch.train``) and the dry run, ``dryrun.py``
and ``rsnn_cells.py`` (each cell's step traced on ``meta``, its cost a
device recorded)."""
