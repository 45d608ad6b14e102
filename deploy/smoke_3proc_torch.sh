#!/usr/bin/env bash
# Smoke-test the PyTorch port's 3-process topology (the counterpart of
# deploy/smoke_3proc.sh) without docker: a standalone API with TCP ingest and
# the web console (python -m blah2_tpu_torch.net.api), then a radar process
# with --no-api --tcp-egress --cpis 3 streaming the six JSON products over
# localhost TCP into it, then the REST surface. The compose file
# deploy/docker-compose-3proc-torch.yml adds only containers and the nginx
# proxy around exactly this.
#
#   bash deploy/smoke_3proc_torch.sh [config]   # default config/config-synthetic.yml
#   BLAH2_SMOKE_DEVICE=cpu bash deploy/smoke_3proc_torch.sh   # on the CPU
#
# The radar runs on the card unless BLAH2_SMOKE_DEVICE names a device (it
# passes --device); without a card and without it the radar exits 2 ("no
# CUDA device") and so does the smoke. The radar starts only once the API's
# ingest ports accept connections. Exits 0 iff the radar exits 0, the third
# CPI's products have crossed (timing nCpi == 3), and the API serves a map,
# detection, timing, IQ data, the map stash, the web console and its
# favicon.
set -u
cd "$(dirname "$0")/.."
CFG="${1:-config/config-synthetic.yml}"
CPIS=3
DEVICE_FLAG=${BLAH2_SMOKE_DEVICE:+--device $BLAH2_SMOKE_DEVICE}
export PYTHONPATH="$PWD"
python -m blah2_tpu_torch.net.api -c "$CFG" & API_PID=$!
RADAR_PID=
cleanup() {
  status=$?
  kill $RADAR_PID "$API_PID" 2>/dev/null
  wait $RADAR_PID "$API_PID" 2>/dev/null
  exit $status
}
trap cleanup EXIT

# The radar's senders connect at start: wait for every ingest port.
python -m blah2_tpu_torch.net.topology wait "$CFG" --pid "$API_PID" || exit 1

python -m blah2_tpu_torch.runtime.cli -c "$CFG" --no-api --tcp-egress \
  --cpis $CPIS --quiet $DEVICE_FLAG & RADAR_PID=$!
deadline=$((SECONDS + 600))
while kill -0 "$RADAR_PID" 2>/dev/null; do
  if [ $SECONDS -ge $deadline ]; then
    echo "FAIL: radar still running after 600 s"; exit 1
  fi
  sleep 0.5
done
wait "$RADAR_PID"; rc=$?
RADAR_PID=
if [ $rc -ne 0 ]; then echo "FAIL: radar exited $rc"; exit $rc; fi

python -m blah2_tpu_torch.net.topology rest "$CFG" --cpis $CPIS
fail=$?
[ $fail -eq 0 ] && echo "3proc smoke OK" || echo "3proc smoke FAILED"
exit $fail
