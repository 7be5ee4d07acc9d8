"""The front-end (top-K, BRIEF, matching, pyramid) and the visual-odometry
back-end: ``lie`` (SO(3) / SE(3)), ``twoview`` (essential RANSAC, pose
recovery, ray depths), ``ba`` (Schur bundle adjustment), ``posegraph``
(pose graph, rotation averaging, scale drift) and ``slam`` (the odometry
and loop-closure path)."""
