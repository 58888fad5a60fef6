#!/usr/bin/env bash
# Round-close evidence checklist: one command that runs every CPU gate and
# prints a dated evidence table, so a gate result can't silently go
# unrecorded. The GPU gates are `python chip_smoke.py` (and `--four`) on
# the card.
#
#   tools/round_close.sh            # asan + suite + benchsuite smoke + dryrun
#   tools/round_close.sh --full-ci  # additionally run the full ci_matrix
#
# Each gate records PASS / FAIL / SKIP; the script exits nonzero if any gate
# FAILed but still prints the evidence table first.
set -u
cd "$(dirname "$0")/.."

FULL_CI=0
for a in "$@"; do
  case "$a" in
    --full-ci) FULL_CI=1 ;;
    *) echo "unknown arg: $a"; exit 2 ;;
  esac
done

STAMP=$(date -u +"%Y-%m-%d %H:%MZ")
LOGDIR=$(mktemp -d /tmp/round_close.XXXXXX)
declare -A RESULT
FAILED=0

gate() {
  local name="$1"; shift
  echo "=== [$name] start $(date -u +%H:%M:%SZ)"
  if "$@" >"$LOGDIR/$name.log" 2>&1; then
    RESULT[$name]=PASS
    echo "=== [$name] PASS"
  else
    RESULT[$name]=FAIL
    FAILED=1
    echo "=== [$name] FAIL (log: $LOGDIR/$name.log, tail:)"
    tail -15 "$LOGDIR/$name.log"
  fi
}

skip() { RESULT[$1]=SKIP; echo "=== [$1] SKIP ($2)"; }

gate "asan" tools/asan_check.sh
gate "suite" python -m pytest tests/ -x -q
gate "benchsmoke" env PYTHONPATH= JAX_PLATFORMS=cpu python tools/benchsuite.py --smoke
gate "multichip8" bash -c 'PYTHONPATH= JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"'
if [ "$FULL_CI" = 1 ]; then
  gate "ci_matrix" tools/ci_matrix.sh
else
  skip "ci_matrix" "--full-ci not requested; suite+benchsmoke cover the defaults"
fi

echo ""
echo "### Round-close evidence ($STAMP, tools/round_close.sh)"
echo ""
echo "| Gate | Result |"
echo "|---|---|"
for g in asan suite benchsmoke multichip8 ci_matrix; do
  echo "| $g | ${RESULT[$g]:-?} |"
done
echo ""
echo "Logs: $LOGDIR"
exit $FAILED
