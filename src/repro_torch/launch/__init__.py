"""Entry points (port of ``repro.launch``): the trainer CLI
(``launch.train``) for every family of the registry. The mesh, sharding,
step builders, dry run and roofline come with ROADMAP.md Queue 1, item 9
(9.3)."""
