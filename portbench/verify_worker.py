"""One worker of the reference's verify, run as its own process.

    python3 portbench/verify_worker.py < sets.json

reads a JSON list of [pk, msg, sig, dst] hex strings on standard input and
writes the JSON list of `reference.bls.verify` verdicts on standard
output.  It loads the reference alone.
"""

import json
import sys

from reference import bls

sets = json.loads(sys.stdin.read())
json.dump([bls.verify(*(bytes.fromhex(x) for x in s)) for s in sets],
          sys.stdout)
