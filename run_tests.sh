#!/usr/bin/env bash
# One-command green suite with per-file process isolation.
#
# Why not plain `pytest tests/`: a single long-lived process accumulates
# hundreds of XLA CPU-mesh compilations and eventually segfaults inside
# jaxlib's backend_compile_and_load (observed reproducibly ~70-85 test
# files into a serialized whole-suite run; every file passes in its own
# process).  This is process longevity in the XLA CPU compiler, not a
# femto_tpu logic bug.
# The mitigation is the same one the reference uses for its MPI tests
# (one mpirun per test binary, SURVEY.md §4): one process per test file.
#
# Usage:  ./run_tests.sh [-jN] [pytest args...]
#   -jN   run N files concurrently (default: 4)
# Any further args are passed to every pytest invocation.

set -u
cd "$(dirname "$0")"

JOBS=4
if [[ "${1:-}" =~ ^-j([0-9]+)$ ]]; then
  JOBS="${BASH_REMATCH[1]}"
  shift
fi

FILES=$(ls tests/test_*.py)
LOGDIR=$(mktemp -d /tmp/femto_tpu_tests.XXXXXX)
declare -A PIDS
FAIL=0

run_one() {
  local f="$1" log="$2"
  shift 2
  python -m pytest "$f" -q --no-header "$@" >"$log" 2>&1
}

active=0
for f in $FILES; do
  log="$LOGDIR/$(basename "$f").log"
  run_one "$f" "$log" "$@" &
  PIDS[$!]="$f"
  active=$((active + 1))
  if [[ $active -ge $JOBS ]]; then
    wait -n -p DONE_PID
    rc=$?
    donef="${PIDS[$DONE_PID]}"
    unset "PIDS[$DONE_PID]"
    active=$((active - 1))
    tail=$(tail -1 "$LOGDIR/$(basename "$donef").log")
    if [[ $rc -ne 0 ]]; then
      FAIL=1
      echo "FAIL  $donef  ($tail)"
      cat "$LOGDIR/$(basename "$donef").log"
    else
      echo "ok    $donef  ($tail)"
    fi
  fi
done

for pid in "${!PIDS[@]}"; do
  f="${PIDS[$pid]}"
  wait "$pid"
  rc=$?
  tail=$(tail -1 "$LOGDIR/$(basename "$f").log")
  if [[ $rc -ne 0 ]]; then
    FAIL=1
    echo "FAIL  $f  ($tail)"
    cat "$LOGDIR/$(basename "$f").log"
  else
    echo "ok    $f  ($tail)"
  fi
done

rm -rf "$LOGDIR"
if [[ $FAIL -ne 0 ]]; then
  echo "SUITE: FAIL"
  exit 1
fi
echo "SUITE: all files green"
