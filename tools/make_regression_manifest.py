#!/usr/bin/env python
"""Generate tests/regression_manifest.json: sha256 of every corpus decode.

The analog of the reference's pinned-version regression fuzz target
(`/root/reference/fuzz/fuzz_targets/regression.rs`): future changes must keep
exact-mode output byte-identical for every successfully-decoding corpus image
(and keep failures failing with the same error type). Re-run this tool only
when an output change is intended and explain why in the commit.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from conftest import crashtest_files, reftest_files  # noqa: E402

from jpeg_decoder_jax import Decoder, JpegError  # noqa: E402


def outcome(path) -> str:
    try:
        data = Decoder(str(path)).decode()
        return "sha256:" + hashlib.sha256(data).hexdigest()
    except JpegError as e:
        return "error:" + type(e).__name__


def main() -> None:
    manifest = {}
    for p in sorted(reftest_files()) + sorted(crashtest_files()):
        key = str(p).replace("/root/reference/tests/", "")
        manifest[key] = outcome(p)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tests", "regression_manifest.json")
    with open(out, "w") as f:
        json.dump(manifest, f, indent=0, sort_keys=True)
    print(f"wrote {out}: {len(manifest)} entries")


if __name__ == "__main__":
    main()
