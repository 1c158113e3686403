"""Entry points: ``serve``, ``train``, ``elastic`` and ``trace``, and
``mesh`` (device meshes and local ranks)."""
