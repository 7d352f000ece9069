"""One module a kind of system, named by a configuration file's "system"
key and found by that name; each holds the port's construction of the
system and the benchmark's plain reference of it:

  build(cfg, port)          (System, integrator) of the port's package
                            `port`, the System checked against the
                            configuration's published parameters
  topology(cfg)             the reference's view of one replica; the
                            harness reads `n0`, `site_mass`, `massive`,
                            `drude_pairs` and `box` (a cubic edge) of it
  reference(cfg, device, arith)  (topology, field, integrator): `field`
                            has forces(x), pair_count(x) and at_box(box);
                            `integrator` start(x, v) and step(state)
"""
