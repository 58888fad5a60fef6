#!/usr/bin/env bash
# Configuration-matrix gate — the analog of the reference's CI matrix
# (`/root/reference/.github/workflows/rust.yml`: {toolchains} x {features} x
# {ISAs}). The axes that exist in this framework:
#
#   1. native C++ entropy engine        vs  pure-Python oracle (JPEG_JAX_DISABLE_NATIVE)
#   2. jax on CPU                       vs  jax on the default platform
#   3. single device                    vs  8-device virtual mesh (parallel tests)
#
# Runs the full test suite under each configuration plus the multichip dryrun.
# Usage: tools/ci_matrix.sh [pytest-args...]
set -u

cd "$(dirname "$0")/.."
FAILED=0
run() {
  local name="$1"; shift
  echo "=== [$name] $*"
  if "$@"; then echo "=== [$name] PASS"; else echo "=== [$name] FAIL"; FAILED=1; fi
}

# 1. Default: native engine, jax-CPU, 8-device virtual mesh (conftest pins CPU).
run "native+cpu8" python -m pytest tests/ -x -q "$@"

# 2. Native disabled: every path through the pure-Python entropy oracle.
run "oracle+cpu8" env JPEG_JAX_DISABLE_NATIVE=1 \
    python -m pytest tests/ -x -q "$@"

# 3. Multichip dryrun at two mesh sizes (clean env: no conftest, honours
#    whatever platform the driver would use; forced to CPU here).
for n in 4 8; do
  run "dryrun$n" env PYTHONPATH= JAX_PLATFORMS=cpu \
      XLA_FLAGS="--xla_force_host_platform_device_count=$n" \
      python -c "import __graft_entry__ as g; g.dryrun_multichip($n)"
done

# 3b. Multi-process mesh (2 jax.distributed processes, gloo on localhost):
#     process-local staging -> global batch axis + cross-process halo
#     collectives, bit-exact (SURVEY.md §4 multi-host decode tests).
run "multiproc2" env PYTHONPATH= python tools/multiproc_mesh.py

# 4. Compile-check the single-device entry point.
run "entry" env PYTHONPATH= JAX_PLATFORMS=cpu \
    python -c "import __graft_entry__ as g; fn, args = g.entry(); fn(*args)"

# 5. Fuzz spot-check (three-way differential, 200 mutants).
run "fuzz200" python tools/fuzz.py 200 1

# 6. Device-engine differential fuzz (prescan-accepted streams must match
#    oracle stores bit-exact; CPU/XLA engine).
run "fuzzdev200" env PYTHONPATH= python tools/fuzz.py 200 1 --device

# 8. Speculative prescan forced onto every baseline stream (4 KiB threshold):
#    anchors must stay byte-identical under the parallel split.
run "specprescan" env JPEG_JAX_SPEC_PRESCAN=4096 python -m pytest \
    tests/test_prescan_parity.py tests/test_device_entropy.py \
    tests/test_stream_bits.py -x -q "$@"

# 8b. ...and under mutation: the spec splicer must accept-or-fallback with
#     bit-exact stores on malformed streams too (the default 256 KiB
#     threshold means plain fuzzdev never reaches the splice logic).
run "fuzzdev-spec" env PYTHONPATH= JPEG_JAX_SPEC_PRESCAN=4096 \
    python tools/fuzz.py 150 11 --device

# 9. Benchmark smoke (the reference CI *runs* its benches,
#    /root/reference/.github/workflows/rust.yml:36-40): a perf-path import
#    or staging regression must fail the gate, not the next bench run.
#    --smoke decodes each bench input once on the CPU.
run "benchsmoke" env PYTHONPATH= JAX_PLATFORMS=cpu \
    python tools/benchsuite.py --smoke

exit $FAILED
