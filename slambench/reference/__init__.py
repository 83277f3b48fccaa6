"""The plain reference that decides ``correct``: a frozen copy, in plain
PyTorch, of the port's front-end as it stood when the benchmark was
written (``frontend/{clustering,edges,flow_mask,fusion,orb,rag_merge,
pipeline}.py``, ``ops/{flow,image,homography}.py``, the frame's
``_depth_ur``), with the plain versions of the four hand-written kernels in
``kernels.py`` and the settings in ``config.py``. It imports nothing of the
port, so a later change to the program does not move it. It is held to the
JAX package, the system the port was written from, by the CPU test
``tests/test_slambench_reference_jax.py``, not to the port. ``compare.py``
holds the numbers the check compares."""
