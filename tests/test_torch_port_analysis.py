"""rxtpu_torch.analysis (csv rows) against rxtpu.analysis (pandas frames),
on the CPU: every function on the ``synthetic_root`` fixture's metadata,
rxtpu's invariant-violation case (``tests/test_analysis.py:35-45``) and a
plate missing its controls, the siRNA plate structure on
``make_plate_balanced_train_df``, and the report of ``main``."""

from __future__ import annotations

import math
import os

import pandas as pd
import pytest

from rxtpu import analysis as rx
from rxtpu.data.synthetic import make_plate_balanced_train_df
from rxtpu_torch import analysis as port
from rxtpu_torch.data.records import read_csv


def _meta(root, split):
    path = os.path.join(root, "metadata")
    return (read_csv(os.path.join(path, f"{split}.csv")),
            read_csv(os.path.join(path, f"{split}_controls.csv")),
            pd.read_csv(os.path.join(path, f"{split}.csv")),
            pd.read_csv(os.path.join(path, f"{split}_controls.csv")))


def _rows(df: pd.DataFrame):
    return [{k: (int(v) if k in ("plate", "sirna") else v) for k, v in r.items()}
            for r in df.to_dict("records")]


def test_parse_id_code_matches_rxtpu():
    for code in ("HUVEC-01_3_B05", "U2OS-02_1_B02", "RPE-07_4_O23", "HEPG2-11_2_C10"):
        assert port.parse_id_code(code) == rx.parse_id_code(code)


@pytest.mark.parametrize("split", ["train", "test"])
def test_summaries_match_rxtpu(synthetic_root, split):
    root, _ = synthetic_root
    rows, controls, df, dfc = _meta(root, split)
    want = {ct: {k: int(v) for k, v in cols.items()}
            for ct, cols in rx.celltype_summary(df).to_dict(orient="index").items()}
    got = port.celltype_summary(rows)
    assert got == want and list(got) == sorted(want)
    assert ("sirnas" in next(iter(got.values()))) == (split == "train")
    cs = rx.control_summary(dfc)
    want_cs = {(e, int(p)): {t: int(cs.loc[(e, p), t]) for t in cs.columns}
               for e, p in cs.index}
    assert port.control_summary(controls) == want_cs
    inv = port.check_control_invariants(controls)
    assert inv == rx.check_control_invariants(dfc) and all(inv.values())


def test_invariant_violations_match_rxtpu():
    """rxtpu's case (the negative control off B02), and a plate with no
    controls of either type besides one other well type."""
    cases = [
        [dict(id_code="E-1_1_B05", experiment="E-1", plate=1, well="B05", sirna=1138,
              well_type="negative_control"),
         dict(id_code="E-1_1_B20", experiment="E-1", plate=1, well="B20", sirna=1108,
              well_type="positive_control")],
        [dict(id_code="E-1_1_B02", experiment="E-1", plate=1, well="B02", sirna=1138,
              well_type="negative_control"),
         dict(id_code="E-1_1_B20", experiment="E-1", plate=1, well="B20", sirna=1108,
              well_type="positive_control"),
         dict(id_code="E-1_2_B21", experiment="E-1", plate=2, well="B21", sirna=1109,
              well_type="empty")],
    ]
    for rows in cases:
        got = port.check_control_invariants(rows)
        assert got == rx.check_control_invariants(pd.DataFrame(rows))
        assert not all(got.values())
    assert port.check_control_invariants(cases[0])["every_plate_has_negative_control"]
    assert not port.check_control_invariants(cases[0])["negative_control_at_B02"]
    assert port.control_summary(cases[1]) == {
        ("E-1", 1): {"empty": 0, "negative_control": 1, "positive_control": 1},
        ("E-1", 2): {"empty": 1, "negative_control": 0, "positive_control": 0}}


@pytest.mark.parametrize("nb_classes,seed", [(12, 1), (40, 3), (1, 0)])
def test_sirna_plate_structure_matches_rxtpu(nb_classes, seed):
    """pandas' ``describe`` statistics, the std with ddof 1 (NaN for one
    siRNA) and the linear quartiles; then uneven plate counts."""
    df = make_plate_balanced_train_df(nb_classes=nb_classes, seed=seed)
    frames = [df, df[~((df.sirna % 3 == 0) & (df.plate == df.plate.max()))]]
    for frame in frames:
        want = rx.sirna_plate_structure(frame)["plates"].to_dict()
        got = port.sirna_plate_structure(_rows(frame))
        assert list(got) == list(want)
        for key in want:
            if math.isnan(want[key]):
                assert math.isnan(got[key]), key
            else:
                assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-12), key
    assert port.sirna_plate_structure(_rows(df))["min"] == 3.0


def test_main_report(synthetic_root, capsys):
    root, _ = synthetic_root
    meta = os.path.join(root, "metadata")
    assert port.main(["--metadata", meta]) == 0
    got = capsys.readouterr().out
    rx.main(["--metadata", meta])
    want = capsys.readouterr().out
    pick = [line for line in want.splitlines() if line.startswith(("==", "  every", "  neg",
                                                                   "sirna"))]
    assert pick and pick == [line for line in got.splitlines()
                             if line.startswith(("==", "  every", "  neg", "sirna"))]
    for celltype in port.celltype_summary(read_csv(os.path.join(meta, "train.csv"))):
        assert celltype in got
