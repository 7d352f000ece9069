"""PDB reading and writing: enough for the reference's bundled data files
(example/nacl_1m.pdb, nacl_1m_pos.pdb: ATOM/HETATM records and CRYST1).
A copy of the JAX package's io/pdbfile.py, which the port may not
import; the two read and write the same files."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class PDBAtom:
    serial: int
    name: str
    res_name: str
    chain: str
    res_seq: int
    element: str


@dataclasses.dataclass
class PDBTopology:
    atoms: List[PDBAtom]

    def __len__(self):
        return len(self.atoms)

    def residues(self):
        """Group atoms into residues: maximal runs of identical
        (chain, res_seq, res_name).  Returns [(res_name, [atom indices])]
        in file order (the role of OpenMM's Topology.residues())."""
        out: List[tuple] = []
        key = None
        for i, a in enumerate(self.atoms):
            k = (a.chain, a.res_seq, a.res_name)
            if k != key:
                out.append((a.res_name, []))
                key = k
            out[-1][1].append(i)
        return out


class PDBFile:
    """Parses ATOM/HETATM/CRYST1 records.  positions are in nm (PDB files
    store angstroms)."""

    def __init__(self, path: str):
        atoms: List[PDBAtom] = []
        coords: List[tuple] = []
        self.box = None
        with open(path) as f:
            for line in f:
                rec = line[:6]
                if rec == "CRYST1":
                    a = float(line[6:15]) * 0.1
                    b = float(line[15:24]) * 0.1
                    c = float(line[24:33]) * 0.1
                    self.box = np.diag([a, b, c])
                elif rec in ("ATOM  ", "HETATM"):
                    name = line[12:16].strip()
                    element = line[76:78].strip() if len(line) > 76 else ""
                    if not element:
                        element = name[:1]
                    atoms.append(PDBAtom(
                        serial=int(line[6:11]),
                        name=name,
                        res_name=line[17:21].strip(),
                        chain=line[21],
                        res_seq=int(line[22:26]),
                        element=element,
                    ))
                    coords.append((float(line[30:38]), float(line[38:46]),
                                   float(line[46:54])))
        self.topology = PDBTopology(atoms)
        if self.box is not None:
            self.topology.box = self.box
        self.positions = np.array(coords, np.float64) * 0.1  # A -> nm

    def getTopology(self):
        return self.topology

    def getPositions(self, asNumpy: bool = True):
        return self.positions

    @staticmethod
    def writeFile(topology, positions, file, box_nm=None) -> None:
        """OpenMM's PDBFile.writeFile(topology, positions, file): `file`
        an open handle or a path; positions in nm."""
        box = box_nm if box_nm is not None else getattr(topology, "box", None)
        if box is not None:
            box = np.diagonal(box) if np.ndim(box) == 2 else box
        if hasattr(file, "write"):
            write_model(file, positions, topology, model=1, box_nm=box)
        else:
            with open(file, "w") as f:
                write_model(f, positions, topology, model=1, box_nm=box)


def write_model(f, positions_nm: np.ndarray, topology: Optional[PDBTopology],
                model: int = 1, box_nm=None) -> None:
    pos = np.asarray(positions_nm, np.float64) * 10.0
    if box_nm is not None:
        b = np.asarray(box_nm) * 10.0
        f.write(f"CRYST1{b[0]:9.3f}{b[1]:9.3f}{b[2]:9.3f}"
                f"  90.00  90.00  90.00 P 1           1\n")
    f.write(f"MODEL     {model:4d}\n")
    for i, p in enumerate(pos):
        if topology is not None and i < len(topology.atoms):
            a = topology.atoms[i]
            name, res, chain, seq, elem = (a.name, a.res_name, a.chain,
                                           a.res_seq, a.element)
        else:
            name, res, chain, seq, elem = "X", "UNK", "A", i // 1000 + 1, "X"
        # the column layout of the reference's example PDBs (resName at
        # columns 17-20, chain 21, x at 30), which the reader takes back
        f.write(f"ATOM  {(i + 1) % 100000:5d} {name:<4.4s} {res:<4.4s}"
                f"{chain:1.1s}{seq % 10000:4d}    "
                f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}"
                f"  1.00  0.00          {elem:>2.2s}\n")
    f.write("ENDMDL\n")


def write_pdb(path: str, positions_nm, topology=None, box_nm=None) -> None:
    with open(path, "w") as f:
        write_model(f, positions_nm, topology, model=1, box_nm=box_nm)
