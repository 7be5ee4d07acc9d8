"""Differential-test oracles (the reference's `opencv_compat` role): a
scalar Python transcription of the FAST semantics (``naive``) and a scalar
C++ one built with g++ (``native``), independent of the port's kernels and
of its plain PyTorch detector."""
