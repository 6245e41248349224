"""Paper Table 1: per-iteration communication rounds/bits cost model.

Port of ``benchmarks/table1_comm_model.py``: the same arithmetic and the
same assertions."""
from __future__ import annotations

from repro_torch.core.metrics import CommModel


def run(log=print):
    log("== Table 1: communication cost model (d-dim model, M workers) ==")
    m = CommModel(d=11_173_962, k=111_740, M=10)  # ResNet18-scale, top-1%
    log(f"{'method':8s} {'#rounds/iter':>14s} {'#bits/upload':>14s} "
        f"{'total(T=100, sum|M^t|=600)':>28s}")
    rows = [
        ("sgd", m.M, 32 * m.d, m.total_bits("sgd", 100)),
        ("sparse", m.M, 32 * m.k, m.total_bits("sparse", 100)),
        ("lasg", "|M^t|", 32 * m.d, m.total_bits("lasg", 100, 600)),
        ("sasg", "|M^t|", 32 * m.k, m.total_bits("sasg", 100, 600)),
    ]
    out = []
    for name, rounds, bits, total in rows:
        log(f"{name:8s} {str(rounds):>14s} {bits:>14.3e} {total:>28.3e}")
        out.append({"method": name, "bits_per_upload": bits, "total_bits": total})
    # consistency: SASG saves both factors
    if not out[3]["total_bits"] < out[1]["total_bits"] < out[0]["total_bits"]:
        raise AssertionError("Table 1: expected SASG < Sparse < SGD in total bits")
    if not out[3]["total_bits"] < out[2]["total_bits"]:
        raise AssertionError("Table 1: expected SASG < LASG in total bits")
    log("ok: SASG < {Sparse, LASG} < SGD\n")
    return {"table1": out}


if __name__ == "__main__":
    run()
