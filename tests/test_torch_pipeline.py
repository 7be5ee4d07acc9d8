"""The port's 3-stage front-end pipeline on the CPU, against the JAX
package's sequential front-end (as tests/test_pipeline.py holds the JAX
pipeline).

The stages run on three repeated CPU devices.  Keypoints, descriptors and
matches are integers, so every comparison is exact; the port's descriptors
are int32 bit patterns and are viewed as uint32.  Steered BRIEF bins come
from float32 ``atan2`` (tests/test_torch_brief.py allows a slot within
1e-4 of a bin edge to differ); on this stream every slot agrees exactly,
and the test holds it to that.
"""

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu.models import brief as jax_brief, match as jax_match
from feature_detector_fast_tpu_torch.models import brief
from feature_detector_fast_tpu_torch.parallel import pipeline

K = 64
THRESHOLD = 16
COUNT = 9
CPU = torch.device("cpu")


def frame_stream(rng, b=5, h=48, w=128) -> np.ndarray:
    """The stream of tests/test_pipeline.py: shifted copies of one noisy
    frame, so consecutive frames share structure and match."""
    base = rng.integers(0, 256, (h, w + b), np.uint8)
    return np.stack([base[:, i: i + w] for i in range(b)])


def jax_sequential(frames, oriented):
    out, prev = [], None
    for img in frames:
        kps, desc, dvalid = jax_brief.detect_and_describe(img, THRESHOLD, COUNT, K, oriented)
        if prev is None:
            m = (np.full((K,), -1, np.int32), np.full((K,), jax_brief.BITS + 1, np.int32))
        else:
            mm = jax_match.match(desc, dvalid, *prev)
            m = (np.asarray(mm.idx_b), np.asarray(mm.dist))
        out.append((kps, np.asarray(desc), np.asarray(dvalid), m))
        prev = (desc, dvalid)
    return out


@pytest.mark.parametrize("oriented", [False, True], ids=["plain", "steered"])
def test_pipeline_matches_jax_sequential(rng, oriented):
    frames = frame_stream(rng, b=5 if not oriented else 4)
    stream = pipeline.frontend_pipelined(frames, THRESHOLD, COUNT, K,
                                         mesh=pipeline.make_pipe_mesh([CPU] * 3),
                                         oriented=oriented)
    ref = jax_sequential(frames, oriented)
    assert any((m[0] >= 0).any() for *_, m in ref[1:]), "the stream has no matches"
    assert stream.desc.dtype == torch.int32 and stream.kp_valid.dtype == torch.bool
    for i, (kps, desc, dvalid, (idx, dist)) in enumerate(ref):
        np.testing.assert_array_equal(stream.kp_xy[i].numpy(), np.asarray(kps.xy))
        np.testing.assert_array_equal(stream.kp_score[i].numpy(), np.asarray(kps.score))
        np.testing.assert_array_equal(stream.kp_valid[i].numpy(), np.asarray(kps.valid))
        np.testing.assert_array_equal(stream.dvalid[i].numpy(), dvalid)
        np.testing.assert_array_equal(stream.desc[i].numpy().view(np.uint32)[dvalid], desc[dvalid])
        np.testing.assert_array_equal(stream.match_idx[i].numpy(), idx)
        np.testing.assert_array_equal(stream.match_dist[i].numpy(), dist)


def test_pipeline_matches_port_sequential(rng):
    """frontend_pipelined == the port's own detect_and_describe + match on
    the CPU, including the invalid slots' descriptor words."""
    from feature_detector_fast_tpu_torch.models import match

    frames = frame_stream(rng, b=3)
    stream = pipeline.frontend_pipelined(frames, THRESHOLD, COUNT, K,
                                         mesh=pipeline.make_pipe_mesh([CPU] * 4))
    prev = None
    for i, img in enumerate(frames):
        kps, desc, dvalid = brief.detect_and_describe(img, THRESHOLD, COUNT, K, device="cpu")
        assert torch.equal(stream.desc[i], desc) and torch.equal(stream.kp_xy[i], kps.xy)
        if prev is not None:
            assert torch.equal(stream.match_idx[i], match.match(desc, dvalid, *prev).idx_b)
        prev = (desc, dvalid)


def test_pipe_mesh_requires_three_devices():
    with pytest.raises(ValueError, match="3 devices"):
        pipeline.make_pipe_mesh([CPU] * 2)
    with pytest.raises(ValueError, match="device type"):
        pipeline.make_pipe_mesh([CPU, CPU, torch.device("meta")])
    assert pipeline.make_pipe_mesh([CPU] * 3).shape == {pipeline.PIPE_AXIS: 3}
