"""idle.verify.fs: `idle.verify` read in the Fiat-Shamir cell, where it moves
`statement_s` (that cell reports no `prove_s` or `verify_s`)."""

from portbench import harness

read = harness.load_reader("idle.verify").read
