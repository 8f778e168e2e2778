"""g1_roofline.prove.fs: `g1_roofline.prove` read in the Fiat-Shamir cell, where it moves
`statement_s` (that cell reports no `prove_s` or `verify_s`)."""

from portbench import harness

read = harness.load_reader("g1_roofline.prove").read
