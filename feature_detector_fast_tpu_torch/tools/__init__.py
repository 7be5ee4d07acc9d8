"""The port's tools: counterparts of the JAX package's ``tools/``.

Each module has a ``run(..., device=...)`` generator that yields the tool's
JSON records, and a ``main()`` that prints them, one per line, with the
card (``nvidia-smi`` name and power limit) on stderr:

    python -m feature_detector_fast_tpu_torch.tools.<name> [--device cpu]

* ``acceptance`` -- every mode x count of the FAST kernels, against the plain
  detector and the native scalar oracle, BRIEF and the goldens on the card
  (counterpart of ``tools/tpu_acceptance.py``);
* ``resolution_bench``, ``sweep``, ``serving_bench``, ``frontend_bench``,
  ``scaling_bench`` -- the measurement tools of the same names;
* ``exp_off_floor``, ``exp_off_prepack``, ``exp_off_byteswar`` -- the OFF
  words kernel's floors and variants, on the kernels of ``csrc/exp_off.cu``;
* ``vo_bench`` -- full visual odometry (rendered VGA circuit, K=512) in
  frames/s and ATE, host and device-resident frames, odometry or (``--loops``)
  loops + bundle adjustment;
* ``run_slam_demo`` -- the staged SLAM demo: synthetic correspondences, a
  rendered circuit (odometry, loops, BA), a KITTI / TUM sequence directory or
  a directory of images;
* ``exp_r5_f256_mesh`` -- the scale evaluation of the SLAM back-end: the
  128-frame staged circuit on one device and the 256-frame quad-lap circuit
  with bundle adjustment on a mesh, against the JAX package's staged gates;
* ``exp_vo_stages``, ``exp_frontend_stages`` -- the stage profiles of the VO
  geometry and of the 1080p front-end.

The default device is ``"cuda"``, which raises without CUDA; ``"cpu"`` runs
the plain PyTorch versions at whatever size is asked (the tests use tiny
ones), and its times are host times of the CPU, not device numbers.
"""
