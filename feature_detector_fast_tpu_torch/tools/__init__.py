"""The port's tools: counterparts of the JAX package's ``tools/``.

Each module has a ``run(..., device=...)`` generator that yields the tool's
JSON records, and a ``main()`` that prints them, one per line, with the
card (``nvidia-smi`` name and power limit) on stderr:

    python -m feature_detector_fast_tpu_torch.tools.<name> [--device cpu]

* ``acceptance`` -- every mode x count of the FAST kernels, BRIEF and the
  goldens on the card (counterpart of ``tools/tpu_acceptance.py``);
* ``resolution_bench``, ``sweep``, ``serving_bench``, ``frontend_bench``,
  ``scaling_bench`` -- the measurement tools of the same names;
* ``exp_off_floor``, ``exp_off_prepack``, ``exp_off_byteswar`` -- the OFF
  words kernel's floors and variants, on the kernels of ``csrc/exp_off.cu``;
* ``vo_bench`` -- full visual odometry (rendered VGA circuit, K=512) in
  frames/s and ATE, host and device-resident frames.

The default device is ``"cuda"``, which raises without CUDA; ``"cpu"`` runs
the plain PyTorch versions at whatever size is asked (the tests use tiny
ones), and its times are host times of the CPU, not device numbers.
"""
