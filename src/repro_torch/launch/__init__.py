"""Entry points (port of ``repro.launch``): the trainer CLI
(``launch.train``). The mesh, sharding, step builders, dry run and
roofline come with ROADMAP.md Queue 1, item 9."""
