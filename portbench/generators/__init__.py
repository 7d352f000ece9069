"""One module a traffic generator, named by a traffic file's "generator"
key (portbench/traffic/<mix>.json) and found by that name:

  validate(traffic)                     the file's parameters, checked
  prepare(system, traffic, port)        adds what the ensemble needs to
                                        the port's System
  velocities(topology, traffic, R, seed)  (R, n0, 3) start velocities
"""
