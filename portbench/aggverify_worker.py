"""One worker of the reference's FastAggregateVerify, run as its own
process.

    python3 portbench/aggverify_worker.py < sets.json

reads a JSON list of [keys, msg, sig, dst] hex strings on standard input,
the keys a set's 48-byte compressed encodings back to back, and writes
the JSON list of `reference.aggregate.fast_aggregate_verify` verdicts on
standard output.  It loads the reference alone.
"""

import json
import sys

from reference import aggregate

KEY_BYTES = 48

sets = json.loads(sys.stdin.read())
out = []
for keys, msg, sig, dst in ([bytes.fromhex(x) for x in s] for s in sets):
    out.append(aggregate.fast_aggregate_verify(
        [keys[k:k + KEY_BYTES] for k in range(0, len(keys), KEY_BYTES)],
        msg, sig, dst))
json.dump(out, sys.stdout)
