"""Entry points and the launch layer (port of ``repro.launch``).

  train       the trainer CLI for every family of the registry;
  mesh        ``DeviceMesh``es over ``torch.distributed`` (the production
              (16, 16) and (2, 16, 16) meshes, the host's ranks);
  sharding    the reference's rules as spec trees and DTensor placements;
  shapes      the 40 (architecture x input shape) cells, abstract inputs;
  steps       one program a family and step kind (``build_cell_program``);
  dryrun      every cell traced on 256 or 512 fake ranks, nothing allocated;
  accounting  an LM cell's cost a layer, extrapolated to its depth;
  roofline    the dry-run records against H100 SXM.

On the CPU the sharded programs run on ``gloo`` ranks
(``tests/test_torch_sharded.py`` starts four); the dry run needs no group
of its own (``python -m repro_torch.launch.dryrun --all``); on the card
``chip_smoke.py --phases 14`` runs them at world 1 over NCCL.
"""
