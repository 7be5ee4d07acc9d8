"""The front-end: top-K keypoints, BRIEF descriptors, matching, pyramid."""
