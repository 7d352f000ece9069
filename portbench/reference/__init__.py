"""The benchmark's plain reference of SWM4-NDP water under the TGNH
integrator: a straightforward float64 implementation of the same
semantics as the program under test, written from the published model
and the reference plugin's step, and importing nothing of the program.

water.py    the topology and parameters of a configuration file
forces.py   Ewald direct space on its own cell list, smooth PME, the
            exclusion correction, the Drude springs, the M site
tgnh.py     one TGNH step: CM removal, NH chain half steps, kicks,
            SHAKE/RATTLE on the rigid triangles, the hard wall
precision.py  float64, and the float32-with-TF32 control
"""
