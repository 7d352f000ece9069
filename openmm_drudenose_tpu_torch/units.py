"""Units and physical constants (OpenMM's MD unit system).

Lengths in nm, times in ps, masses in dalton, charges in e, energies in
kJ/mol, temperatures in K; velocities are nm/ps and forces kJ/mol/nm.
A copy of the JAX package's constants, so the port imports nothing of it.
"""

# Boltzmann constant times Avogadro, kJ/(mol K) (OpenMM's BOLTZ).
BOLTZ = 8.31446261815324e-3

# Coulomb constant 1/(4 pi eps0) in kJ nm / (mol e^2) (OpenMM's ONE_4PI_EPS0).
ONE_4PI_EPS0 = 138.935456


# kcal/mol in kJ/mol, and one bar in kJ/(mol nm^3) (OpenMM's AVOGADRO x
# 1e-25: 1 bar = 1e5 Pa = 1e5 J/m^3)
KCAL_PER_MOL = 4.184
BAR_TO_KJ_PER_MOL_NM3 = 0.06022140857


def ns_per_day(steps_per_second: float, step_size_ps: float) -> float:
    """steps/s and a step size in ps -> simulated ns per wall-clock day."""
    return steps_per_second * step_size_ps * 1e-3 * 86400.0
