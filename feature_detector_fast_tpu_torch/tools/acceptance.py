"""Acceptance of the port's kernels on the card: the CUDA counterpart of ``tools/tpu_acceptance.py``.

For every nonmax mode x count 9..=16 (24 configs) on the benchmark frame
(``INPUT_FILE`` or ``media/golden_1080p.png``), at t=16:

  * the dense kernel (``fdf_fast_dense``) == the plain PyTorch detector
    (``ops/fast.py``): mask and score;
  * the words kernel (``fdf_fast_words``) == the words packed from the dense
    kernel's mask.

Then BRIEF: ``describe_patched`` (plain and steered) == the sparse
``describe`` / ``describe_oriented`` at every valid slot of the k=512 top
keypoints (SumAbsolute, t=16, n=9), validity included; and the golden
counts 309 / 131 / 135 on the committed 300 x 200 frame through
``detect_arrays``.  Every check runs once: a mismatch is a failure, there
is no retry.

Each check is one JSON line on stdout; the last line is
``{"ok": ..., "configs": N, "failures": [...], "device": ...}``, and the
exit code is 1 if anything failed.  ``--artifact PATH`` also writes the
full record -- git commit, the port package's git tree id, card, frame,
configs passed, goldens, failures -- as JSON, as ``ACCEPTANCE_rNN.json``
records the TPU runs.

    python -m feature_detector_fast_tpu_torch.tools.acceptance [--artifact PATH] [--device cpu]
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Iterator, List

import numpy as np
import torch

from ..api import detect_arrays
from ..config import Config, NonmaxMode
from ..models import brief
from ..ops import compact, fast, fast_cuda
from ..utils.image import load_luma8
from . import _common

#: The committed 300 x 200 frame at t=16, n=9 (tests/test_golden.py).
GOLDEN = {NonmaxMode.OFF: 309, NonmaxMode.MAX_THRESHOLD: 131, NonmaxMode.SUM_ABSOLUTE: 135}
BRIEF_K = 512


def _git_head() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             cwd=_common.REPO)
    except OSError:
        return "unknown"
    return out.stdout.strip() or "unknown"


def _git_object(kind: bytes, data: bytes) -> bytes:
    return hashlib.sha1(kind + b" %d\0" % len(data) + data).digest()


def package_tree(path: str = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))):
    """The git tree id of the directory ``path`` (by default the port
    package) as a commit holds it -- ``git rev-parse <commit>:<path>`` --
    computed from the files themselves, so that an artifact names the code
    that wrote it in a checkout without git metadata.  Build outputs
    (``_build``) and bytecode caches are skipped, as git ignores them; an
    empty directory gives None."""
    entries = []
    for name in os.listdir(path):
        full = os.path.join(path, name)
        if name in ("_build", "__pycache__"):
            continue
        if os.path.isdir(full):
            tree = package_tree(full)
            if tree is not None:
                entries.append((name.encode() + b"/", b"40000 " + name.encode(),
                                bytes.fromhex(tree)))
        else:
            with open(full, "rb") as f:
                blob = _git_object(b"blob", f.read())
            mode = b"100755" if os.access(full, os.X_OK) else b"100644"
            entries.append((name.encode(), mode + b" " + name.encode(), blob))
    if not entries:
        return None
    return _git_object(b"tree", b"".join(head + b"\0" + sha
                                         for _, head, sha in sorted(entries))).hex()


def run(*, device="cuda", frame: np.ndarray = None, artifact: str = None) -> Iterator[dict]:
    dev, card = _common.start(device)
    img = _common.build_1080p_frame() if frame is None else frame
    small = load_luma8(os.path.join(_common.MEDIA, "Screenshot315_torch_grey.png"))
    im = torch.from_numpy(img)[None].to(dev)
    failures: List[str] = []
    configs_passed: List[str] = []

    def record(tag: str, ok: bool, what: str, **extra) -> dict:
        if not ok:
            failures.append(f"{tag}: {what}")
        _common.log(f"{tag}: {'ok' if ok else 'FAIL ' + what}")
        return {"check": tag, "ok": ok, **extra, "device": card}

    n_cfg = 0
    for mode in NonmaxMode:
        for count in range(9, 17):
            n_cfg += 1
            k_mask, k_score = fast_cuda.detect_dense(im, 16, count, mode)
            p_mask, p_score = fast.detect_dense(im, 16, count, mode)
            words = fast_cuda.detect_words(im, 16, count, mode)
            dense_ok = (torch.equal(k_mask.to(torch.int32), p_mask.to(torch.int32))
                        and torch.equal(k_score.to(torch.int32), p_score.to(torch.int32)))
            words_ok = torch.equal(words, compact.pack_mask_words(k_mask.to(torch.bool)))
            tag = f"{mode.name} c={count}"
            if dense_ok and words_ok:
                configs_passed.append(tag)
            yield record(tag, dense_ok and words_ok,
                         f"dense == plain: {dense_ok}, words == packed dense: {words_ok}",
                         dense=dense_ok, words=words_ok, keypoints=int(p_mask.sum()))

    mask, score = fast_cuda.detect_dense(im, 16, 9, NonmaxMode.SUM_ABSOLUTE)
    kps = brief.select_topk(mask, score, BRIEF_K)
    for oriented, ref_fn in ((False, brief.describe), (True, brief.describe_oriented)):
        d_ref, v_ref = ref_fn(im, kps)
        d_p, v_p = brief.describe_patched(im, kps, oriented=oriented)
        ok = torch.equal(v_ref, v_p) and torch.equal(d_ref[v_ref], d_p[v_ref])
        yield record(f"BRIEF patched oriented={oriented}", ok,
                     "descriptors or validity differ from the sparse gather",
                     valid_slots=int(v_ref.sum()))

    goldens = {}
    for mode, want in GOLDEN.items():
        got = len(detect_arrays(small, Config(16, 9, mode), device=dev))
        goldens[mode.name] = {"got": got, "want": want}
        yield record(f"golden {mode.name}", got == want, f"{got} != {want}", got=got, want=want)

    if artifact:
        rec = {
            "ok": not failures,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "git_head": _git_head(),
            "package_tree": package_tree(),
            "device": card,
            "torch_device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "frame": os.environ.get("INPUT_FILE", "media/golden_1080p.png") if frame is None
                     else f"given, {img.shape[0]} x {img.shape[1]}",
            "configs_run": n_cfg,
            "configs_passed": configs_passed,
            "brief_checked": True,
            "brief_k": BRIEF_K,
            "goldens": goldens,
            "failures": failures,
        }
        with open(artifact, "w") as f:
            json.dump(rec, f, indent=1)
        _common.log(f"artifact written: {artifact}")
    yield {"ok": not failures, "configs": n_cfg, "failures": failures, "device": card}


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("--artifact", metavar="PATH", default=None,
                    help="write the full acceptance record as JSON")
    args = ap.parse_args(argv)
    last = None
    for rec in run(device=args.device, artifact=args.artifact):
        print(json.dumps(rec), flush=True)
        last = rec
    return 0 if last["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
