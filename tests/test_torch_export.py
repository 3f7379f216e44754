"""The port's inference export and load (mirrors
``tests/models/test_export.py``), and archives passed between the two
packages: an ``MLPClassifier``, a GPT-2 and a factory ``Sequential``
exported by either package load in the other, rebuild the same
architecture and predict the same.

Tolerances: the weights cross bit for bit; the two forwards compute in f32
(JAX at its highest matmul precision) in other summation orders, within
1e-5 relative and 1e-6 absolute (1e-5 absolute for GPT-2's logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.models.export import Predictor as JPredictor
from mila_tpu.models.export import export_model as j_export_model
from mila_tpu.models.export import load_exported as j_load_exported
from mila_tpu.models.gpt2 import GPT2 as JGPT2
from mila_tpu.models.gpt2 import GPT2Config as JGPT2Config
from mila_tpu.models.mlp_classifier import MLPClassifier as JMLP
from mila_tpu.models.mlp_classifier import MLPClassifierConfig as JMLPConfig
from mila_tpu.nn import Gelu as JGelu
from mila_tpu.nn import Linear as JLinear
from mila_tpu.nn import LinearConfig as JLinearConfig
from mila_tpu.nn import Sequential as JSequential
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.models.export import Predictor, _model_registry, export_model, load_exported
from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config
from mila_tpu_torch.models.mlp_classifier import MLPClassifier, MLPClassifierConfig
from mila_tpu_torch.models.model import Model, ModelConfig
from mila_tpu_torch.nn import Gelu, Linear, LinearConfig, Sequential
from mila_tpu_torch.nn.factory import create_component, create_network, network_to_spec
from mila_tpu_torch.serialization import load_checkpoint
from mila_tpu_torch.utils.registry import models as model_registry


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _x(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


_GPT2 = dict(vocab_size=64, max_seq_len=16, num_layers=1, num_heads=2, embedding_dim=32)


class TestExportLoad:
    def test_gpt2_round_trip(self, tmp_path):
        model = GPT2(GPT2Config(**_GPT2), device="cpu")
        params = model.init(_gen(0), (1, 8))
        p = tmp_path / "gpt2.mila"
        export_model(p, model, params)
        model2, params2 = load_exported(p, device="cpu")
        toks = torch.tensor([[1, 2, 3]], dtype=torch.int32)
        torch.testing.assert_close(model.apply(params, toks), model2.apply(params2, toks),
                                   rtol=1e-5, atol=1e-6)
        assert model2.config.num_heads == 2

    def test_mlp_classifier_round_trip(self, tmp_path):
        model = MLPClassifier(MLPClassifierConfig(hidden_dims=(32, 16)))
        params = model.init(_gen(0), (1, 784), device="cpu")
        p = tmp_path / "mlp.mila"
        export_model(p, model, params)
        x = _x(0, 3, 784)
        pred = Predictor.from_archive(p, device="cpu")
        torch.testing.assert_close(pred.predict_batch(x), model.apply(params, x), rtol=1e-5,
                                   atol=1e-6)
        assert pred.predict(x[0]).shape == (10,)

    def test_sequential_via_factory_spec(self, tmp_path):
        net = Sequential([("fc1", Linear(LinearConfig(in_features=8, out_features=16))),
                          ("act", Gelu()),
                          ("fc2", Linear(LinearConfig(in_features=16, out_features=4)))])
        params = net.init(_gen(0), (1, 8), device="cpu")
        p = tmp_path / "seq.mila"
        export_model(p, net, params)
        net2, params2 = load_exported(p, device="cpu")
        x = _x(1, 2, 8)
        torch.testing.assert_close(net.apply(params, x), net2.apply(params2, x), rtol=1e-5,
                                   atol=1e-6)

    def test_unknown_module_rejected(self, tmp_path):
        from mila_tpu_torch.nn.module import Module

        class Custom(Module):
            def apply(self, params, x, **kw):
                return x

        with pytest.raises(ValueError, match="cannot export"):
            export_model(tmp_path / "x.mila", Custom(), {})

    def test_dtype_cast_on_load(self, tmp_path):
        model = MLPClassifier(MLPClassifierConfig(hidden_dims=(16,)))
        params = model.init(_gen(0), (1, 784), device="cpu")
        p = tmp_path / "m.mila"
        export_model(p, model, params)
        _, params_bf16 = load_exported(p, dtype=torch.bfloat16, device="cpu")
        assert params_bf16["fc1"]["weight"].dtype == torch.bfloat16


def test_registries_and_factory():
    _model_registry()
    assert {"GPT2", "Llama", "MLPClassifier"} <= set(model_registry.names())
    lin = create_component("Linear", {"in_features": 3, "out_features": 5, "name": "fc"})
    assert isinstance(lin, Linear) and lin.config.out_features == 5
    spec = [{"type": "Linear", "name": "a", "config": {"in_features": 4, "out_features": 2}},
            {"type": "Gelu", "config": {"approximation": "exact"}}]
    net = create_network(spec)
    assert [n for n, _ in net.children()] == ["a", "gelu1"]
    assert network_to_spec(net)[1]["config"]["approximation"] == "exact"


def test_model_export_writes_params_without_optimizer(tmp_path):
    m = Model(MLPClassifier(MLPClassifierConfig(hidden_dims=(8,))),
              config=ModelConfig(name="m", verbose=False), device="cpu")
    m.build(0, (4, 784))
    m.export(tmp_path / "e.mila")
    data = load_checkpoint(tmp_path / "e.mila")
    assert data["optimizer"] is None and data["meta"]["mode"] == "export"
    assert data["config"]["prefetch_depth"] == 2
    for layer in ("fc1", "head"):
        for name, a in m.params[layer].items():
            assert torch.equal(a, data["params"][layer][name])


# --------------------------------------------------------------------------
# Between the packages
# --------------------------------------------------------------------------

def _jax_cases():
    key = jax.random.key(0)
    mlp = JMLP(JMLPConfig(hidden_dims=(32, 16)))
    gpt2 = JGPT2(JGPT2Config(**_GPT2))
    seq = JSequential([("fc1", JLinear(JLinearConfig(in_features=8, out_features=16))),
                       ("act", JGelu()),
                       ("fc2", JLinear(JLinearConfig(in_features=16, out_features=4)))])
    return {
        "mlp": (mlp, mlp.init(key, (1, 784)), np.asarray(_x(2, 3, 784)), 1e-6),
        "gpt2": (gpt2, gpt2.init(key, (1, 8)), np.array([[1, 2, 3, 60]], np.int32), 1e-5),
        "sequential": (seq, seq.init(key, (1, 8)), np.asarray(_x(3, 2, 8)), 1e-6),
    }


@pytest.mark.parametrize("case", ["mlp", "gpt2", "sequential"])
def test_jax_export_loads_and_predicts_in_the_port(tmp_path, case):
    jmodule, jparams, x, atol = _jax_cases()[case]
    p = tmp_path / f"{case}.mila"
    j_export_model(p, jmodule, jparams)
    pred = Predictor.from_archive(p, device="cpu")
    assert type(pred.module).__name__ == type(jmodule).__name__
    assert pred.module.config.to_dict() == jmodule.config.to_dict()
    want = np.asarray(JPredictor.from_archive(p).predict_batch(x))
    np.testing.assert_allclose(pred.predict_batch(x).numpy(), want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("case", ["mlp", "gpt2", "sequential"])
def test_port_export_loads_and_predicts_in_jax(tmp_path, case):
    jmodule, jparams, x, atol = _jax_cases()[case]
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    if case == "mlp":
        tmodule = MLPClassifier(MLPClassifierConfig(hidden_dims=(32, 16)))
    elif case == "gpt2":
        tmodule = GPT2(GPT2Config(**_GPT2), device="cpu")
    else:
        tmodule = create_network([{"type": "Linear", "name": "fc1",
                                   "config": {"in_features": 8, "out_features": 16}},
                                  {"type": "Gelu", "name": "act"},
                                  {"type": "Linear", "name": "fc2",
                                   "config": {"in_features": 16, "out_features": 4}}])
    p = tmp_path / f"{case}.mila"
    export_model(p, tmodule, tparams)
    jmod2, jp2 = j_load_exported(p)
    assert type(jmod2).__name__ == type(tmodule).__name__
    for a, b in zip(jax.tree_util.tree_leaves(jp2), jax.tree_util.tree_leaves(jparams)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    got = np.asarray(jmod2.apply(jp2, jnp.asarray(x)))
    want = Predictor(tmodule, tparams).predict_batch(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
