"""The port's parallel layer on torch.distributed (counterpart of the JAX
package's parallel/): one process per rank, started by `torchrun` or by
`torch.multiprocessing.spawn`, every rank running the same Trainer or CLI
over the same global batch list and taking its own share.

Modules:
- mesh: the process group, the ("data", "model") shape, this rank's device,
  the backend rule and the communication ops (all_reduce_sum, ppermute,
  all_gather, gather_object) with their autograd rules;
- train_step: data-parallel training steps and the sharded decode;
- sequence: the unit axis sharded over ranks, a halo exchange per layer;
- pipeline: GPipe over contiguous stages of the BERT-style encoder;
- expert: SwitchBiLSTM's two LSTM towers, one per rank;
- multihost: start-up from the environment, per-rank document shards and
  equal-shape local batches;
- dryrun: N spawned ranks through every mode, one summary line.
"""
