"""The port's field-regression experiment and its spatio-temporal loader
against the JAX package, on the CPU.

The loaders are numpy transcriptions of the JAX package's pandas code, so
they are held to exact equality; the site joins to pandas' merges on the
shipped artifacts; the experiment runs end to end at a tiny size (its band
is held on the card by chip_smoke.py).
"""

import numpy as np
import pandas as pd
import pytest

from nonstationary_precip_tpu.data import datasets as jax_datasets
from nonstationary_precip_tpu.utils.config import DATASET_DIR
from nonstationary_precip_tpu_torch.data import datasets
from nonstationary_precip_tpu_torch.experiments import field_regression as fr


def test_spatio_temporal_loader_and_month_split_match_jax_exactly():
    _, x, y = datasets.load_uib_spatio_temporal()
    _, xj, yj = jax_datasets.load_uib_spatio_temporal()
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)
    ours, ref = datasets.spatio_temporal_month_split(), jax_datasets.spatio_temporal_month_split()
    assert ours[0].shape == (172, 3) and ours[2].shape == (43, 3)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_month_sites_are_the_jax_experiments_month_5_rows():
    df = pd.read_csv(DATASET_DIR / "uib_spatio_temporal.csv")
    d2 = df[df["time"] < 2001].copy()
    d2["month"] = d2["time"].rank(method="dense").astype(int)
    m5 = d2[d2["month"] == 5]
    sites = fr._month_sites(5)
    np.testing.assert_array_equal(sites[:, 1], m5["lon"].values)
    np.testing.assert_array_equal(sites[:, 2], m5["lat"].values)


@pytest.mark.parametrize("artifact", ["f_mean_sigma_dgp2.csv", "dgp2_spatio_temporal_means_sigmas.csv"])
def test_artifact_reader_and_site_join_match_pandas(artifact):
    """The artifact as pandas reads it, and the (lat, lon) inner join as
    pandas' merge gives it: against the spatial sites and against month 5."""
    ref = datasets.read_columns(f"{fr.ARTIFACTS}/{artifact}", fr.FIELD_COLUMNS)
    ref_pd = pd.read_csv(DATASET_DIR / fr.ARTIFACTS / artifact, index_col=0)
    np.testing.assert_array_equal(ref[:, 1:], ref_pd[["pred", "std", "lat", "lon"]].values)
    data = datasets.load_uib_spatial()[1]
    st = fr._month_sites(5)
    for lon, lat in ((data[:, 0], data[:, 1]), (st[:, 1], st[:, 2])):
        right = pd.DataFrame({"lat": lat, "lon": lon, "j": np.arange(len(lat))})
        merged = ref_pd.reset_index().merge(right, on=["lat", "lon"])
        li, ri = fr._inner_join(ref[:, 3], ref[:, 4], lat, lon)
        np.testing.assert_array_equal(li, merged["index"].values)
        np.testing.assert_array_equal(ri, merged["j"].values)


def test_main_cpu_smoke(tmp_path, monkeypatch):
    """``main`` end to end on the CPU at 2 epochs and M = 16, both halves:
    finite metrics, and the field CSV as pandas reads it."""
    monkeypatch.setenv("NSGP_RESULTS_DIR", str(tmp_path))
    argv = ["--num_epochs", "2", "--num_inducing", "16", "--device", "cpu"]
    rmse, one_minus_corr = fr.main(argv)
    assert np.isfinite(rmse) and np.isfinite(one_minus_corr)
    out = pd.read_csv(tmp_path / fr.FIELD_CSV, index_col=0)
    assert list(out.columns) == ["pred", "std", "lat", "lon"] and len(out) == 394
    assert np.isfinite(out.values).all()
    res = fr.run(fr.default_config().parse_args(argv + ["--model", "spatial"]))
    assert res["spatial_steps"] == 2 and "st_corr" not in res
    np.testing.assert_allclose(res["rmse_vs_ref"], rmse, rtol=1e-6)
