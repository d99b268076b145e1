"""The readings behind the AccessAnomaly tolerances of ``test_torch_anomaly.py``.

Runs every test there that holds the port's scores to the reference's
(through its ``_check``) and prints, for each comparison, the largest
|port - reference| score difference in z units, the largest |mean / std| of
the tenants compared, that difference as a share of the dot (the
``dots_agree`` scale) and the rule and limit the test holds it to. Run from
the repo's root, on the CPU:

    JAX_PLATFORMS=cpu python tests/anomaly_readings.py
"""

import inspect
import pathlib
import sys
import tempfile

import numpy as np

sys.path[:0] = [str(pathlib.Path(__file__).parent), str(pathlib.Path(__file__).parents[1])]

import torch  # noqa: E402

import test_torch_anomaly as T  # noqa: E402

readings = []
_check = T._check


def _reading(ref, port, cols, tol=T.ANOMALY_TOL, of_dot=False):
    a, b = _check(ref, port, cols, tol, of_dot)
    ok = np.isfinite(a)
    by_tenant = T.port_anomaly.tenant_centres(ref.user_vectors)
    centres = np.abs([by_tenant.get(t, 0.0) for t in np.asarray(cols["tenant"]).astype(str)])
    err = np.abs(b[ok] - a[ok])
    share = err / np.maximum(1.0, np.abs(a[ok]) + centres[ok])
    readings.append((err.max(initial=0.0), centres[ok].max(initial=0.0),
                     share.max(initial=0.0), "dots_agree" if of_dot else "scores_agree", tol))
    return a, b


def main():
    torch.set_num_threads(1)
    T._check = _reading
    for name, fn in inspect.getmembers(T, inspect.isfunction):
        params = inspect.signature(fn).parameters
        if not name.startswith("test_") or "monkeypatch" in params or "seed" in params:
            continue
        for case in ([{"implicit": True}, {"implicit": False}] if "implicit" in params
                     else [{}]):
            kw = dict(case)
            if "tmp_path" in params:
                kw["tmp_path"] = pathlib.Path(tempfile.mkdtemp())
            readings.clear()
            fn(**kw)
            for err, centre, share, rule, tol in readings:
                print(f"{name}{case or ''}: {err:.3e} in z units, |mean / std| <= {centre:.3g}, "
                      f"{share:.3e} of the dot; held by {rule} to {tol}")


if __name__ == "__main__":
    main()
