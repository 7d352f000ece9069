"""System description: particles, constraints, virtual sites, forces, box.

OpenMM-shaped host-side builders (addParticle, addConstraint,
setVirtualSite, setDefaultPeriodicBoxVectors, addForce), as in the JAX
package's system.py, with its four kinds of virtual site.  core/spec.build_spec compiles a System and an
integrator into tensors.  Periodic boxes are orthorhombic or triclinic
in OpenMM's reduced form (forces/boxutils.py).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .forces.boxutils import reduce_box


class VirtualSite:
    """Base class of massless sites placed from other particles."""

    particles: Tuple[int, ...]


class TwoParticleAverageSite(VirtualSite):
    def __init__(self, particle1: int, particle2: int, weight1: float,
                 weight2: float):
        self.particles = (particle1, particle2)
        self.weights = (weight1, weight2)


class ThreeParticleAverageSite(VirtualSite):
    """pos = w1*p1 + w2*p2 + w3*p3 (the SWM4-NDP water M site)."""

    def __init__(self, particle1: int, particle2: int, particle3: int,
                 weight1: float, weight2: float, weight3: float):
        self.particles = (particle1, particle2, particle3)
        self.weights = (weight1, weight2, weight3)


class OutOfPlaneSite(VirtualSite):
    """pos = p1 + w12 r12 + w13 r13 + wcross (r12 x r13), r1k = pk - p1."""

    def __init__(self, particle1: int, particle2: int, particle3: int,
                 weight12: float, weight13: float, weightCross: float):
        self.particles = (particle1, particle2, particle3)
        self.weights = (weight12, weight13, weightCross)


class LocalCoordinatesSite(VirtualSite):
    """A site at a fixed position in a local frame made of weighted sums
    of its parents (OpenMM's semantics; the lone pairs of CHARMM-Drude
    decks):

      origin = sum_i ow_i p_i
      xdir   = sum_i xw_i p_i,  ydir = sum_i yw_i p_i
      x^ = xdir/|xdir|; z^ = (xdir x ydir)/|...|; y^ = z^ x x^
      pos = origin + local[0] x^ + local[1] y^ + local[2] z^
    """

    def __init__(self, particles: Sequence[int],
                 originWeights: Sequence[float],
                 xWeights: Sequence[float], yWeights: Sequence[float],
                 localPosition: Sequence[float]):
        if not (len(particles) == len(originWeights) == len(xWeights)
                == len(yWeights)):
            raise ValueError("particles and weight lists must match")
        self.particles = tuple(int(p) for p in particles)
        self.origin_weights = tuple(float(w) for w in originWeights)
        self.x_weights = tuple(float(w) for w in xWeights)
        self.y_weights = tuple(float(w) for w in yWeights)
        self.local_position = tuple(float(w) for w in localPosition)


class System:
    """Container for the physical description of a simulated system."""

    def __init__(self):
        self._masses: List[float] = []
        self._constraints: List[Tuple[int, int, float]] = []
        self._virtual_sites: dict[int, VirtualSite] = {}
        self._forces: List[object] = []
        self._box = ((2.0, 0.0, 0.0), (0.0, 2.0, 0.0), (0.0, 0.0, 2.0))

    def addParticle(self, mass: float) -> int:
        self._masses.append(float(mass))
        return len(self._masses) - 1

    def getNumParticles(self) -> int:
        return len(self._masses)

    def getParticleMass(self, index: int) -> float:
        return self._masses[index]

    def setParticleMass(self, index: int, mass: float) -> None:
        self._masses[index] = float(mass)

    def addConstraint(self, particle1: int, particle2: int,
                      distance: float) -> int:
        self._constraints.append((int(particle1), int(particle2),
                                  float(distance)))
        return len(self._constraints) - 1

    def getNumConstraints(self) -> int:
        return len(self._constraints)

    def getConstraintParameters(self, index: int) -> Tuple[int, int, float]:
        return self._constraints[index]

    def setVirtualSite(self, index: int, site: VirtualSite) -> None:
        self._virtual_sites[int(index)] = site

    def isVirtualSite(self, index: int) -> bool:
        return int(index) in self._virtual_sites

    def getVirtualSite(self, index: int) -> VirtualSite:
        return self._virtual_sites[int(index)]

    def addForce(self, force) -> int:
        self._forces.append(force)
        return len(self._forces) - 1

    def getNumForces(self) -> int:
        return len(self._forces)

    def getForce(self, index: int):
        return self._forces[index]

    def getForces(self) -> Sequence[object]:
        return list(self._forces)

    def removeForce(self, index: int) -> None:
        del self._forces[index]

    def setDefaultPeriodicBoxVectors(self, a, b, c) -> None:
        """Orthorhombic boxes, and triclinic cells in OpenMM's convention
        (a along x, b in the xy plane), reduced to the form |bx| <= ax/2,
        |cx| <= ax/2, |cy| <= by/2 as OpenMM does (the JAX package's
        system.py:143-152)."""
        box = reduce_box([a, b, c])
        self._box = tuple(tuple(float(v) for v in row) for row in box)

    def getDefaultPeriodicBoxVectors(self):
        return self._box

    def usesPeriodicBoundaryConditions(self) -> bool:
        return any(getattr(f, "usesPeriodicBoundaryConditions",
                           lambda: False)() for f in self._forces)
