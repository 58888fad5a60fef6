#!/usr/bin/env bash
# Memory-safety / UB gate for the C++ entropy kernel: builds an ASan+UBSan
# instrumented libjtentropy and drives the reftest corpus, the crashtest
# corpus, and the mutation fuzzers through it. The differential fuzz
# (tools/fuzz.py) proves semantics; this proves the absence of OOB reads/
# writes and undefined arithmetic that semantics checks cannot see.
# Findings fixed via this gate: UB negative-value left shifts in the
# successive-approximation scaling and the stb IDCT (now shl32/-fwrapv).
set -u
cd "$(dirname "$0")/.."

SO=/tmp/libjtentropy_asan.so
g++ -O1 -g -fwrapv -fsanitize=address,undefined -fno-sanitize-recover=undefined \
    -shared -fPIC -std=c++17 -o "$SO" jpeg_decoder_jax/entropy/cpp/entropy.cc \
    -lpthread || exit 1

ASAN_LIB=$(g++ -print-file-name=libasan.so)
UBSAN_LIB=$(g++ -print-file-name=libubsan.so)
export LD_PRELOAD="$ASAN_LIB $UBSAN_LIB"
export ASAN_OPTIONS=detect_leaks=0
export UBSAN_OPTIONS=halt_on_error=1:print_stacktrace=1
export JPEG_JAX_NATIVE_SO="$SO"
export PYTHONPATH=

FAILED=0
run() {
  local name="$1"; shift
  echo "=== [$name]"
  if "$@"; then echo "=== [$name] PASS"; else echo "=== [$name] FAIL"; FAILED=1; fi
}

run "corpora" python - <<'PY'
import glob
import jpeg_decoder_jax as jd
for root in ("/root/reference/tests/reftest/images",
             "/root/reference/tests/crashtest/images"):
    n = 0
    for p in sorted(glob.glob(root + "/**/*.jpg", recursive=True)):
        try:
            d = jd.Decoder(p, backend="numpy")
            d.set_max_decoding_buffer_size(64 << 20)
            d.decode(); n += 1
        except jd.JpegError:
            n += 1
    print(root.split("/")[-2], n, "files clean")
PY

run "fuzz400" python tools/fuzz.py 400 23
run "fuzzdev150" python tools/fuzz.py 150 31 --device

exit $FAILED
