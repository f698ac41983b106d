"""hymba_1p5b's train step and decode step on the card, timed with the
port found under a given source directory: an A/B of two trees of the
repository in one call.

    python3 tests/_lm_ab.py PATH/TO/src

Prints one ``AB`` line: six warm train steps (B=2 x 1,280, remat,
``make_train_step``'s defaults, after one cold step) in ms, and the
median ms of 56 decode steps after 8 (B=2, a 256-slot cache).  Needs a card; imports neither jax
nor the reference.
"""
import sys
import time


def main(src):
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba_1p5b")
    state = init_train_state(cfg, 0, device=dev)
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=2, seq_len=1280)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch_at(0).items()}
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=1,
                                            schedule="const"), remat=True)
    secs = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        secs.append(time.perf_counter() - t)
    params = state["params"]
    del state
    cache = lm.init_cache(cfg, 2, 256, device=dev)
    tok = torch.zeros((2, 1), dtype=torch.long, device=dev)
    dsecs = []
    with torch.inference_mode():
        for pos in range(64):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, tok, cache, pos)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            dsecs.append(time.perf_counter() - t)
    warm = sorted(dsecs[8:])
    print(f"AB {src}: train warm ms "
          f"{[round(x * 1e3, 1) for x in secs[1:]]}, decode ms median "
          f"{warm[len(warm) // 2] * 1e3:.2f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
