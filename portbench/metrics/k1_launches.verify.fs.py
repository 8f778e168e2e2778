"""k1_launches.verify.fs: `k1_launches.verify` read in the Fiat-Shamir cell, where it moves
`statement_s` (that cell reports no `prove_s` or `verify_s`)."""

from portbench import harness

read = harness.load_reader("k1_launches.verify").read
