"""One worker of the reference's `verify_cell_kzg_proof_batch`, run as its
own process.

    python3 portbench/kzgverify_worker.py < batches.json

reads [setup, batches] on standard input: setup the hex of the 64 G1
monomial points' compressed encodings back to back and of [tau^64]G2's;
each batch [commitments, cell indices, cells, proofs], the byte arrays as
hex of their rows back to back.  It writes the JSON list of
`reference.kzg.verify_cell_kzg_proof_batch` verdicts on standard output,
and loads the reference alone.
"""

import json
import sys

from reference import hostmath, kzg

(g1_hex, g2_hex), batches = json.loads(sys.stdin.read())
g1_bytes = bytes.fromhex(g1_hex)
# the setup is trusted: its points are decoded without the subgroup check
setup = ([hostmath.g1_from_compressed(g1_bytes[i:i + 48],
                                      check_subgroup=False)
          for i in range(0, len(g1_bytes), 48)],
         hostmath.g2_from_compressed(bytes.fromhex(g2_hex),
                                     check_subgroup=False))


def rows(hex_str: str, width: int) -> list:
    data = bytes.fromhex(hex_str)
    return [data[i:i + width] for i in range(0, len(data), width)]


out = [kzg.verify_cell_kzg_proof_batch(
    rows(c, kzg.BYTES_PER_COMMITMENT), idx, rows(x, kzg.BYTES_PER_CELL),
    rows(p, kzg.BYTES_PER_PROOF), setup) for c, idx, x, p in batches]
json.dump(out, sys.stdout)
