"""The port's training entry point (substratus_tpu_torch/train/main.py)
and its data, checkpoint and artifact modules, on the CPU.

* PackedDataset draws the JAX package's batches, block for block, from the
  same .jsonl, .txt and .npy corpora and seed.
* train.main with --device cpu: a 6-step LoRA run on a .jsonl corpus
  (checkpoints every 2), rerun as if interrupted after step 4, resumes
  there, and its losses are the uninterrupted run's (the resumed run
  skips the batches the finished steps drew); the artifact reloads to the
  merged model's logits, exactly; the adapter artifact holds the trained
  adapters. A full finetune with grad_accum_steps=2 on a .npy corpus.
* Keys and values the port does not train with exit naming their ROADMAP
  item by its title; quantize without a base model exits (QLoRA needs
  one), and so does a --model that is no local checkpoint; --model on a
  checkpoint trains from its weights; without --device cpu it raises here
  (no card).
"""
import json

import numpy as np
import pytest
import torch

from substratus_tpu.serve.tokenizer import load_tokenizer as j_load_tokenizer
from substratus_tpu.train.data import PackedDataset as JPackedDataset
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
from substratus_tpu_torch.train import main as train_main
from substratus_tpu_torch.train.checkpoints import ADAPTER_FILE, FORMAT, META_FILE, load_artifact
from substratus_tpu_torch.train.data import PackedDataset


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def corpus(tmp_path):
    """A directory with a .jsonl (text and prompt/completion rows), a
    .txt and a .npy token stream."""
    d = tmp_path / "data"
    (d / "sub").mkdir(parents=True)
    rows = [{"text": f"document {i}: " + "the quick brown fox " * (i % 5 + 1)} for i in range(30)]
    rows += [{"prompt": "Q: two plus two? ", "completion": "A: four."}] * 5
    (d / "a.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    (d / "sub" / "b.txt").write_text("a plain text document " * 20)
    np.save(d / "c.npy", np.random.default_rng(0).integers(0, 256, 700).astype(np.int64))
    return d


def test_batches_match_jax(corpus):
    for path in (corpus, corpus / "a.jsonl", corpus / "c.npy"):
        ours = PackedDataset(str(path), ByteTokenizer(), 4, 64, seed=3)
        theirs = JPackedDataset(str(path), j_load_tokenizer(None), 4, 64, seed=3)
        assert ours.n_tokens == theirs.n_tokens
        for _ in range(5):
            a, b = next(ours), next(theirs)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["weights"], b["weights"])


def _run(tmp_path, name, data, **params):
    p = tmp_path / f"{name}.json"
    p.write_text(json.dumps(params))
    out = tmp_path / name
    return train_main.run(["--data", str(data), "--out", str(out), "--params", str(p), "--device", "cpu"]), out


LORA = {"config": "tiny", "batch_size": 4, "seq_len": 32, "learning_rate": 1e-2, "warmup_steps": 1,
        "save_steps": 2, "lora_rank": 4, "lora_alpha": 8, "seed": 1}


def test_lora_run_resumes_and_writes_artifacts(tmp_path, corpus):
    straight, out = _run(tmp_path, "lora", corpus / "a.jsonl", steps=6, **LORA)
    assert straight["start_step"] == 0
    assert len(straight["losses"]) == 6 and all(np.isfinite(straight["losses"]))
    ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
    assert ckpts == ["step_00000002.pt", "step_00000004.pt", "step_00000006.pt"]
    # As if interrupted after step 4: the rerun resumes there.
    (out / "checkpoints" / "step_00000006.pt").unlink()
    resumed, _ = _run(tmp_path, "lora", corpus / "a.jsonl", steps=6, **LORA)
    assert resumed["start_step"] == 4 and resumed["trainer"].step == 6
    np.testing.assert_allclose(resumed["losses"], straight["losses"][4:], rtol=1e-6)

    # The artifact: the merged model, reloaded to the same logits.
    meta = json.loads((out / META_FILE).read_text())
    assert meta["format"] == FORMAT and meta["trained_steps"] == 6 and "attn_impl" not in meta["model_config"]
    cfg, model = load_artifact(str(out), device="cpu")
    trainer = resumed["trainer"]
    tokens = torch.arange(1, 33)[None]
    with torch.inference_mode():
        want, _ = llama.forward(resumed["merged"], tokens, resumed["cfg"])
        got, _ = llama.forward(model, tokens, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # The trainer keeps its base: the merge made new wq/wv and shares the rest.
    assert not torch.equal(resumed["merged"].layers[0].wq, trainer.params.layers[0].wq)
    assert resumed["merged"].layers[0].wk is trainer.params.layers[0].wk
    adapter = torch.load(out / "adapter" / ADAPTER_FILE, weights_only=True)
    assert all(torch.equal(adapter[k], v) for k, v in trainer.lora.state_dict().items())
    assert json.loads((out / "adapter" / META_FILE).read_text())["lora"] == {
        "rank": 4, "alpha": 8.0, "targets": ["wq", "wv"]}


def test_full_finetune_with_accumulation(tmp_path, corpus):
    res, out = _run(tmp_path, "full", corpus / "c.npy", config="tiny", steps=3, batch_size=3, seq_len=32,
                    grad_accum_steps=2, learning_rate=1e-3, attn_impl="plain", dp=1, fsdp=-1)
    assert res["trainer"].tc.grad_accum_steps == 2 and res["cfg"].attn_impl == "plain"
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    cfg, model = load_artifact(str(out), device="cpu")
    assert cfg.vocab_size == ByteTokenizer.vocab_size  # the tokenizer's 258 ids
    for name, t in model.state_dict().items():
        assert torch.equal(t, res["trainer"].params.state_dict()[name])


@pytest.mark.parametrize("params,argv,match", [
    ({"quantize": "int8", "lora_rank": 4}, [], "QLoRA, which needs a base model"),
    ({"sequence": 4}, [], "Queue 1, multi-GPU"),
    ({"attn_impl": "ring", "sequence": 1}, [], "Queue 1, multi-GPU"),
    ({"tensor": 2}, [], "Queue 1, multi-GPU"),
    ({"attn_impl": "pallas"}, [], "invalid"),
    ({"optimizer": "sgd"}, [], "unknown key"),
    ({}, ["--model", "/nonexistent"], "local checkpoints only"),
])
def test_unported_knobs_exit(tmp_path, corpus, params, argv, match):
    p = tmp_path / "params.json"
    p.write_text(json.dumps(params))
    with pytest.raises(SystemExit, match=match):
        train_main.run(["--data", str(corpus), "--out", str(tmp_path / "o"), "--params", str(p),
                        "--device", "cpu", *argv])


def test_model_flag_trains_from_the_checkpoint(tmp_path, corpus):
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    base = llama.init_params(llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32), seed=5,
                             device="cpu")
    write_hf(str(tmp_path / "base"), base)
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"steps": 1, "batch_size": 2, "seq_len": 32, "lora_rank": 4}))
    res = train_main.run(["--data", str(corpus), "--out", str(tmp_path / "o"), "--params", str(p), "--device", "cpu",
                          "--model", str(tmp_path / "base")])
    assert res["cfg"].dtype == torch.bfloat16  # the loaders' default
    for name, t in res["trainer"].params.state_dict().items():  # LoRA: the base stays as loaded
        assert torch.equal(t, base.state_dict()[name].bfloat16()), name


def test_default_device_is_the_card(tmp_path, corpus):
    assert not torch.cuda.is_available()
    assert train_main.parse_args([]).device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main.run(["--data", str(corpus), "--out", str(tmp_path / "o"), "--params", ""])
