"""The paper's own experiments, torch port of ``benchmarks/fpga_repro.py``,
the three paper tables and the four examples of ``examples/``.

* fpga_repro   — FPGA resource vectors, masked training, Algorithm 2 runs
* table2_jets  — Table II: jets MLP, RF sweep, DSP- and BRAM-aware
* table3_svhn  — Table III: SVHN CNN, RF 3/9/27
* table5_lenet — Table V: LeNet, heterogeneous multi-dimensional
* quickstart   — the front-door flow, ending in the BSR kernel
* prune_jets   — one Table II row from the command line
* serve_pruned — train, knapsack-prune and pack a small LM, decode on
  the packed params through the BSR kernel
* train_lm_pruned — the fault-tolerant trainer with checkpoints, then
  Algorithm 2 on the attention and MLP weights

``python -m repro_torch.paper [--only table2,table3,table5] [--quick]
[--device cpu]`` prints the tables as ``name,us_per_call,derived`` CSV.
"""
