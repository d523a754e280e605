#!/bin/bash
# Idle-machine robustness campaign: loop the threaded stress suite (tight
# interleavings surface races loaded runs hide — two bugs were found
# exactly this way), then grind fresh fuzz seeds via tests/marathon.py.
#
#   bash benchmarks/stress_campaign.sh [STRESS_ITERS] [SEED_LO] [SEED_HI]
#
# IMPORTANT: on failure the FULL pytest output is preserved (an earlier
# ad-hoc loop kept only `tail -2` and destroyed the evidence of a
# 1-in-100 interleaving trip).  Each iteration re-invokes pytest, so
# test-code fixes land mid-campaign without a restart.  Stop with the pid
# file, never by pattern:  kill $(cat /tmp/r4_campaign.pid)
set -u
ITERS=${1:-200}
LO=${2:-200}
HI=${3:-400}
export JAX_PLATFORMS=cpu
cd "$(dirname "$0")/.."
for i in $(seq 1 "$ITERS"); do
  echo "=== stress iter $i $(date -u +%H:%M:%S)"
  timeout 300 python -m pytest tests/test_concurrent_stress.py -x -q \
    > /tmp/stress_iter.out 2>&1
  rc=$?
  if [ "$rc" -ne 0 ]; then
    echo "STRESS FAILED iter $i rc=$rc — full output follows"
    cat /tmp/stress_iter.out
    exit 1
  fi
  tail -n 1 /tmp/stress_iter.out
done
echo "STRESS LOOP CLEAN ($ITERS iters); marathon seeds [$LO, $HI)"
# The marathon can die ENVIRONMENTALLY (a long-lived process starved LLVM's
# allocator at seed 225 before marathon.py cleared caches per seed).  A real
# fuzz failure prints a FAIL line and must stop the campaign; an environmental
# crash (no FAIL) restarts from the seed after the last completed one.
MLOG=/tmp/r4_marathon.log
cur=$LO
while [ "$cur" -lt "$HI" ]; do
  : > "$MLOG.cur"
  python tests/marathon.py --seeds "$cur" "$HI" > "$MLOG.cur" 2>&1
  rc=$?
  cat "$MLOG.cur" >> "$MLOG"
  if [ "$rc" -eq 0 ]; then
    echo "MARATHON DONE (seeds $LO-$HI)"
    exit 0
  fi
  if grep -q "^FAIL " "$MLOG.cur"; then
    echo "MARATHON FOUND A FAILURE — full output follows"
    cat "$MLOG.cur"
    exit 1
  fi
  last=$(grep -oE 'seed=[0-9]+' "$MLOG.cur" | tail -1 | cut -d= -f2)
  next=$(( ${last:-$cur} + 1 ))
  echo "marathon crashed environmentally (rc=$rc, last seed ${last:-none}); restarting at $next"
  cur=$next
done
echo "MARATHON DONE (seeds $LO-$HI)"
