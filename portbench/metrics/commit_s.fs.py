"""commit_s.fs: `commit_s` read in the Fiat-Shamir cell, where it moves
`statement_s` (that cell reports no `prove_s` or `verify_s`)."""

from portbench import harness

read = harness.load_reader("commit_s").read
