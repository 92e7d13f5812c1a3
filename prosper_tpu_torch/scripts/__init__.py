"""The TPU measurement scripts' questions asked on the card (counterpart
of the repo's scripts/): leaf visits per ray in K2 and the Möller unit
(bench_visit_breakdown.py), and the fixed costs of loops
(bench_loop_overhead.py). Run each with python -m."""
