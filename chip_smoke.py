#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (substratus_tpu_torch).

    python3 chip_smoke.py            # every phase but profile, one H100
    python3 chip_smoke.py --phases card,build,kernels
    python3 chip_smoke.py --phases card,build,kernels,serve,profile
    python3 chip_smoke.py --phases card,build,kernels,serve-int4,profile
    python3 chip_smoke.py --phases card,build,kernels,train,train-full
    python3 chip_smoke.py --phases card,build,serve-ckpt
    python3 chip_smoke.py --phases card,build,serve,serve-paged,profile
    python3 chip_smoke.py --phases card,build,serve-surface
    python3 chip_smoke.py --phases card,build,kernels,serve-families
    python3 chip_smoke.py --phases card,build,serve-batchgen
    python3 chip_smoke.py --phases card,build,kernels,serve-adapters
    python3 chip_smoke.py --phases card,build,kernels,serve-moe
    python3 chip_smoke.py --phases card,build,serve-disagg
    python3 chip_smoke.py --phases card,build,kernels,serve-w8a8,rl
    python3 chip_smoke.py --phases card,build,kernels,serve-gang

Phases, each of which exits non-zero on failure:

  card        the card's name and power limit (nvidia-smi) and torch's name;
  build       nvcc builds csrc/*.cu for sm_90a (one process per source);
  kernels     each kernel against its plain PyTorch version on the card, in
              bf16 (and int8 caches), at the serving path's shapes (and
              the int4 matmul at llama2-70b's per-rank shapes at tensor 2
              and 8, at 16 and 512 rows; w8a8_quantize's row-parallel
              modes bit for bit): max-abs
              error beside its tolerance, the kernel's time, the plain
              version's, one PyTorch library call's (timed as a yardstick
              only; the port never calls it) and the least time the card
              could take (bytes at 3.35 TB/s, operations at 989 TFLOP/s
              bf16); the decode attention and the fused decode (llama2-7b
              at B=8, GQA 4 and 8, int8 caches, one long conversation at
              B=1 S=4096, positions around the splits, before the cache
              and past it), each launching the design decode_design names
              (csrc/decode_split.cu at head_dim 64 and 128), held per
              output vector against a limit that must also reject the
              output without each slot's last live split, timed with the
              card held and, at the main shapes, in turns with the rows
              design (csrc/decode_attn.cu, csrc/fused_decode.cu) with each
              C entry point's host time; for the fused decode kernel also
              the unfused path's time (row writes plus the decode kernel)
              for the same work;
              the int4 matmul at llama2-7b's projection and lm_head widths,
              timed with the 50 MB L2 flushed (by a 256 MB read) before
              each launch, as a decode step streams 3.5 GB of weights; its
              library call one torch.matmul over the dequantized bf16
              weight; each case launches the design q4_design names
              (q4_matmul_decode.cu at decode rows: llama2-7b's four
              shapes at B=8, one slot, the 16-token bucket, llama3-8b's
              lm_head, each also timed in turns with q4_matmul.cu's
              kernel through the C entry points; q4_matmul_wgmma.cu over
              the prefill buckets and the chunk's four shapes;
              q4_matmul.cu for groups of 64 and N = 1000) and is held
              per output row, a limit that must also reject a dropped
              scale group, a dropped ragged row tile (wgmma) and the
              plan's second split left out (decode); the flash
              backward's dQ and dK/dV kernels at the training shape of
              one llama2-7b layer (B=8, S=1024), GQA, ragged,
              non-causal and tinyllama's heads (the wgmma design,
              csrc/flash_bwd_wgmma.cu) and at head_dim 32 (the mma design,
              csrc/flash_bwd.cu), each launching the design
              flash_bwd_design names, held per output vector against a
              limit that must also reject a planted dropped tile, their
              library call one backward through scaled_dot_product_attention
              (dq, dk and dv at once), beside which dq + dkv + bwd_delta
              is printed; the flash forward (prefill buckets, the training
              shape B=8 S=1024, ragged, GQA, non-causal, tinyllama's heads)
              and the cached flash (the fifth chunk of a long prompt, GQA,
              kv_length, ragged chunks; bf16 and int8 caches), each
              launching the design flash_fwd_design or flash_cached_design
              names (csrc/flash_fwd_wgmma.cu at head_dim 64 and 128), held per
              output vector against a limit that must also reject the
              output without the design's last live k-tile and, at a
              ragged length, with its last q-tile zeroed; at the main
              shapes also timed in turns with the mma design's kernels
              (csrc/flash_fwd.cu, csrc/flash_cached.cu at head_dim 128),
              with each C entry point's host time a call; the
              flash kernels and SDPA timed with the card held until the
              host has enqueued them, SDPA on views of the same tensors as
              in every case (for the forward also on head-major copies,
              beside it);
  serve       serve.main's server in-process at llama2-7b's full width and
              depth (random weights from a seed, bf16, max_seq_len 1024,
              kv_layout dense, as every phase before serve-paged and
              serve-ckpt's and train's servers),
              five concurrent /v1/completions requests, the kernels' launch
              counts against 32 x prefills (all of the flash forward's
              wgmma design) and 32 x decode steps (all of the decode
              kernel's split design), and the
              served tokens held against a direct greedy run of the model;
  serve-long  the same server at max_seq_len 4096 with decode_attn_impl
              "fused": four concurrent requests of about 3000, 1500, 600
              and 40 tokens, whose chunks run through the cached flash
              kernel's wgmma design (32 x prefill chunks) and whose decode
              steps through the fused kernel's split design (32 x steps,
              the decode kernel never); every served greedy token held
              against a single-shot
              forward;
  serve-int4  the JAX package's throughput stack: int4 weights (the random
              bf16 weights quantized on the card), int8 cache, fused
              decode, max_seq_len 2048; serve's five prompts and one of
              1500 tokens (3 chunks); every projection and the lm_head
              through the int4 matmul ((7 x 32 + 1) x forwards: the
              forwards of more than 16 rows through the wgmma design, the
              decode steps and the 16-token bucket through the decode
              design, none through q4_matmul.cu),
              the attention kernels as in serve-long (the cached flash
              over the int8 cache), every served greedy
              token held against a single-shot forward on the int4 weights;
              each serve phase runs the default engine: the overlapped
              scheduler, the decode step one CUDA graph captured at the
              warm-up request, so every step of the run is a replay (a
              kernel's launches: its wrapper's count plus the graph's
              launches a replay times the replays). Then, on the stopped
              engine: serve and serve-int4 serve their requests again
              through overlap=false and the eager step, every greedy
              request token for token the default run's, with that run's
              mean step; every phase holds its sampled tokens inside their
              masks, draws four different rows in four replays at
              temperature 50, and runs 16 overlapped steps at full batch
              whose dispatch makes no host sync (set_sync_debug_mode
              "error"), with their host clock; serve-long also one
              prompt's three chunks with no host sync;
  serve-paged the JAX server's default for llama, the paged pool, in three
              legs: (a) serve.main with serve's knobs and no kv_layout
              (pages of 16, a pool of 8192 tokens, the prefix cache):
              one request of a 480-token prefix (30 pages) and a
              32-token suffix, then 7 concurrent ones sharing the prefix
              (one streamed), then serve's five prompts; exactly 3360
              prefix-hit tokens, every other prompt token prefilled, each
              prompt one chunk through its block-table row, no attention
              kernel launched (the paged read is a gather and the plain
              attention, as in JAX), every greedy token held by the
              teacher-forced reference, the graph engine's greedy tokens
              the eager synchronous paged step's, the sampling and
              sync-free checks of the serve phases, every page back;
              the mean step beside serve's dense one, the prefill of the
              first request against the hits', the pool's bytes; (b) an
              Engine on a pool of 2048 tokens without the prefix cache:
              8 greedy requests of 100-340 tokens, 192 tokens each, at
              least one preempted and resumed, none truncated, each held
              by the reference over its own prompt and every token it
              delivered; (c) serve-int4's weights on int8 pages
              (kv_layout paged, no fused decode): the int4 matmul's
              launches by design, the references;
  serve-spec  speculative decoding at llama2-7b's width, 4 of its 32 layers
              (cut to keep the default run well inside its limit), in three legs ((a)
              the throughput example through serve.main: int4, int8
              pages, B=24, prompt lookup k=3; (b) the dense cache with the
              fused decode; (c) a draft model), each against a plain engine
              on the same requests; then (a)'s running engine serves 24
              greedy requests for at least 32 recorded iterations under
              torch.cuda.set_sync_debug_mode("warn"), and no warned host
              sync may come from a frame under observability/ or inside a
              journey, timeline or SLO recording call;
  serve-ckpt  checkpoints at llama2-7b's full width, 4 of its 32 layers
              (cut to keep the default run in its limit), written from
              the seed-0 weights by tools/ckpt_writer.py, one on disk at a
              time (the free bytes printed before each write, too few fail
              the run): an HF directory of bf16 safetensors shards of at
              most 5 GB, served through serve.main --model with serve's
              knobs, its loaded state bit for bit the source's and its
              greedy tokens those of an in-process engine on the source
              weights, the reference check, the load seconds and GB/s;
              then train.main --model on it with quantize int8 (QLoRA)
              and the train phase's LoRA params for 2 steps (step seconds,
              peak memory, the backward's launches per design); then a
              Q4_0 GGUF (Q8_0 embedding and output, F32 norms, an embedded
              32000-piece SPM vocabulary) served with serve-int4's knobs
              and a prompt of at least 1500 tokens: its loaded state bit
              for bit the writer's dequantization, greedy tokens those of
              an in-process engine on those weights, the int4 path's
              launches per design, every prompt through the vocabulary and
              back, usage equal to the encode lengths, tokens per byte;
              and the loader entry point on each: python -m
              substratus_tpu_torch.load.main --name <the directory> as a
              child under TRACEPARENT (the free bytes printed first; its
              load seconds and GB/s, the artifact's bytes; load.run under
              the trace in its trace.jsonl), the artifact served by
              serve.main --model with serve's knobs, its state bit for bit
              the source's and its greedy tokens the directory's server's;
              with quantize int8, the artifact's int8 weights bit for bit
              the in-process quantize_weights of the same weights and one
              greedy request by the reference rule; on the GGUF, the
              artifact's state bit for bit load_gguf's and tokenizer.gguf
              beside it;
  serve-surface
              the container contract's serving surface: tools/ckpt_writer.py
              writes llama2-7b from seeds 0 and 1 and a 2-layer model of its
              width as Q4_0 GGUFs with the SPM vocabulary and a Llama-2
              chat template; serve.main runs as a child process on the
              seed-0 file with serve-spec (a)'s params (int4, int8 pages,
              B=24, lookup k=3), max_queue 4 and drain_grace 60, in four
              legs: (a) chat, whole and streamed, holds usage to the
              template's rendering; stop cuts an earlier greedy completion
              of the same short prompt (under 16 tokens: no page is shared,
              so runs repeat bit for bit) whole and streamed, never sending
              the stop, its slot free on /loadz; /loadz carries every key
              of the JAX load_snapshot; /metrics parses, its TTFT count is
              the requests served and its spec totals /loadz's; a burst of
              36 gets at least 8 answers of 429 with Retry-After and serves
              the rest whole; an expired deadline 504; (b) /swapz to the
              same file in the middle of a 160-token stream leaves it token
              for token an unswapped run's, seed 1 changes a completion and
              bumps weights_version, seed 0 again gives the first one, the
              2-layer file 409 with the version unmoved, no graph captured
              twice; (d) a 2 s /debug/profile under short-prompt traffic
              writes a trace naming q4_matmul_decode_kernel; (c) SIGTERM
              during a 256-token stream: readiness and /loadz 503 within
              1 s, a new POST 503 with Retry-After, the stream whole, exit
              0 within the grace; the child runs under TRACEPARENT with
              SUBSTRATUS_TRACE_EXPORT, and (e) a whole and a streamed
              request under their own traceparents answer x-trace-id,
              /debug/tracez roots each at serve.http, /debug/requestz?id=
              gives each journey (submit, admit, prefill, drains,
              speculative rounds, end), /debug/perfz, slowz, eventz and
              requestz answer with the JAX keys; after (d) /debug/stepz
              parses as a Chrome trace (its bubble seconds by cause, floor
              estimate and iterations over the run printed) and eventz
              holds the capture's event; at exit the export holds
              serve.start under the child's trace and each request's
              serve.http with engine.prefill under it. It prints the time to ready, the served
              mean round from the phase histogram, and the child's int4
              launches by design (substratus_serve_kernel_launches, counted
              from the end of the warm-up request);
  train       train.main at llama2-7b's full width, 4 of its 32 layers (cut
              to keep the default run well inside its limit; random weights
              from seed 0, bf16) with the finetune example's params: LoRA
              rank 16 on wq/wv, batch 8 x 1024, learning rate 2e-4, remat,
              4 steps (checkpoints every 2) on a seeded token corpus
              (imported by load.dataset's files source), then
              a second call to 6 steps that resumes from step 4, under
              TRACEPARENT with profile_steps [4, 5]: its profile names the
              flash forward and both backward kernels, trace.jsonl holds
              train.run under the trace, each progress line carries the
              trace id, substratus_train_step_seconds counts its steps. Before it,
              one step's adapter gradients through the kernels against
              attn_impl="plain", and the first batch's loss without grad.
              Launches per optimizer step exactly 2 x layers forward (forward
              and recompute), layers dQ and layers dK/dV, all through the wgmma
              designs; every loss finite; the first
              equal to the no-grad loss; the merged artifact reloads to the
              same logits, and serve.main --model serves it with the greedy
              tokens of an in-process engine on the merged model; step
              seconds, tokens/s, MFU, peak memory, the checkpoint and
              artifact seconds;
  train-full  full finetuning (lora_rank 0) through the Trainer at
              llama2-7b's width, 4 layers, batch 2 x 1024, 3 steps: the
              same gradient check over every weight, the launch counts,
              every weight unchanged by step 0 (rate 0) and changed by
              step 1;
  serve-families
              the OPT and Falcon families through the entry points: (a)
              falcon-7b (seed 0, bf16, 71 query heads on one kv head; 8
              of its 32 layers, cut to keep the default run in its limit)
              written by tools/ckpt_writer.py as an HF Falcon directory
              (the fused query_key_value per kv group) and served by
              serve.main --model with examples/falcon-7b-instruct/
              server.yaml's params (max_batch 16; the dense cache, which
              auto resolves to for Falcon): 16 concurrent requests of
              16-600 tokens (the 600 in two chunks), 32 tokens each, one
              streamed, one at temperature 0.8; the loaded state bit for
              bit the source's, the decode kernel launched 32 x decode
              steps at G = 71 (the split design, 9 slices of 8 query
              rows), the flash forward 32 x prefills at H = 71, KH = 1 and
              the cached flash 32 x chunks (wgmma); every greedy token
              held by the single-shot reference, the graph engine's
              tokens the eager synchronous step's, the sampling and
              sync-free checks of the serve phases; the load seconds, the
              mean served step and, under torch.profiler, a full batch's
              step and its device-busy share; (b) the quickstart:
              opt-125m (seed 0) as an HF OPT directory, train.main with
              examples/facebook-opt-125m/finetuned-model.yaml's params (10
              steps, batch 2 x 256, LoRA r8) on a seeded token corpus, its
              artifact served by serve.main --model: the merged weights
              bit for bit, greedy tokens those of an in-process engine on
              them and held by the reference; (c) falcon-7b LoRA at (a)'s
              depth through train.main (r16 on wq/wv, batch 2 x 1024, remat, 2 steps):
              the flash backward at G = 71, 32 dQ and 32 dK/dV launches a
              step, finite losses, the merged artifact reloaded bit for
              bit; (d) facebook/opt-2.7b's shape (hidden 2560, 32 heads:
              head_dim 80, which no kernel is built for; 8 of its 32 layers, FFN
              10240, vocabulary 50272), written by tools/ckpt_writer.py as
              overrides of opt-1.3b, served by serve.main --model with
              (a)'s params: 8 greedy requests of 16-600 tokens, the dense
              cache laid out at head_dim 128 and named so by the startup
              line, every flash, cached-flash and decode launch through
              the padded route (launches_padded), every token by the
              single-shot reference; its LoRA gradients (r16 on wq/wv,
              2 x 512) through the kernels against the plain attention by
              the train phase's rule; 2 LoRA steps through train.main,
              every forward, dQ and dK/dV launch padded. The kernels phase
              holds the new head shapes too: decode at falcon-7b's (B=16,
              bf16 and int8), falcon-40b's (G = 16) and a group of 3, the
              fused decode at G = 71, the flash forward at H = 71, KH = 1
              and the backward at falcon-7b's LoRA shape; and at head_dim
              80 (padded to 128, the bound counted at 80) every family:
              the flash forward, the cached flash (bf16, int8), the decode
              (bf16, int8) and the fused decode over caches laid out at
              128, dQ and dK/dV at opt-2.7b's LoRA shape; and a group of 3
              over an int8 cache of 1022 rows (decode and fused), laid out
              for the split design at 1024 rows;
  serve-batchgen
              examples/batch-generation/batchgen-server.yaml at llama2-7b
              width, 2 of its 32 layers (seed 0, written as an HF
              directory): a 64-record
              manifest (48 text prompts of 16-1000 byte-tokens, 14 of
              token ids, one with no prompt, one naming an adapter). (a)
              python -m substratus_tpu_torch.serve.batchgen as a child with
              the example's params (int8 weights, max_batch 16, maxTokens
              128, the paged pool) and a progress port: every index once,
              62 ok, the invalid and error records; its tokens/s, slot
              occupancy, wall seconds, the mean decode phase from
              /metrics, the weights' bytes and the peak while quantizing;
              (b) the same child SIGKILLed once 16 records are durable, a
              torn line appended to its last shard, the command again:
              every index exactly once, `resumed` the durable count, the
              rerun's records in a fresh shard; (c) the same manifest and
              int8 weights in-process through BatchGenDriver on a dense
              Engine: the decode kernel, the flash forward and the cached
              flash launched 32 a step, prefill and chunk (replays
              included); 8 greedy records of (a) and of (c) by the
              single-shot reference; before (c), one replayed step of the
              example's paged int8 engine at 16 slots under torch.profiler
              (the weights' bf16 copies, the GEMMs, the gather);
  serve-adapters
              multi-tenant LoRA at llama2-7b's full width, 4 of its 32
              layers in (a) and (b) (cut to keep the default run in its
              limit): the seed-0 base written as an HF directory by tools/ckpt_writer.py;
              four tenants as adapter artifacts (random B, so no delta is
              zero): two of rank 16 on all seven targets and one of rank 8
              on wq/wv in the contract's npz format, and the adapters.pt of
              one train.main LoRA step (r16 on wq/wv, rate 1e-3 from step
              0); serve.main --model <the dir> --adapters-dir <the tenants>
              with adapters.capacity 2 (two preloaded, the others hot-load
              and evict) in two legs: (a) the default paged pool in bf16 and
              (b) the dense cache with int4 weights, the int8 cache and the
              fused decode (the flash forward, the cached flash, the fused
              decode and both int4 designs under the tenants' deltas, their
              launches against the forwards), 16 concurrent greedy requests
              of 18-393 tokens over the base and the four tenants, 16
              tokens each (b: and one of 1308 tokens under the trained
              tenant, 3 chunks); each
              leg: usage, the store's hits, hot loads (= evictions: the
              store starts full) and waits against the requests, every
              served token the argmax (or a near-tie within 5% of the logit
              scale) of a single-shot forward with the request's adapter
              applied by the plain lora_delta, the base rows token for token
              an engine with no store (the identity slot exact), the graph
              engine's tokens the eager synchronous step's, a replayed step
              at B=8 with and without the store in turns; (a) also lora-a's
              tokens against an engine on merge_lora(base, lora-a) (a first
              difference a near-tie), and each tenant's load seconds; (c)
              the kernels at head_dim 256 on a served and trained path: a
              llama at gemma-7b's attention widths (16 heads of 256, 4
              layers) on the dense cache with two tenants, once with the
              decode kernel over a bf16 cache and once with the fused decode
              over an int8 cache (6 requests each, one in 2 chunks; every
              flash, cached-flash and decode launch of the design at 256,
              every token by the adapter reference), then one LoRA step
              through the Trainer (dQ and dK/dV of the mma design at 256).
              The kernels phase holds every instance at 256 (and 192,
              padded to 256) against its plain version: the flash forward,
              the cached flash (bf16, int8), the decode and fused decode
              (gemma-7b's heads, gemma-2b's G = 8), a group of 3 on the
              split design's 4-warp instance, dQ and dK/dV;
  serve-moe   mixtral-8x7b at full width (D=4096, M=14336, 8 experts, top
              2, 32 heads on 8 kv heads; seed-0 weights) in four legs: (a)
              int4 at 4 of its 32 layers (MOE_LAYERS), drawn and quantized
              layer by layer on the
              card by serve.main (the peak while drawing printed beside the
              weights), the default engine (the paged pool, overlapped, the
              step one CUDA graph), 8 concurrent greedy requests of 20-400
              tokens, 32 tokens each: every expert product one int4 launch
              an expert, (4 + 3 x 8) x 4 + 1 = 113 launches a forward by
              design (wgmma above 16 rows, decode up to it), every served
              token by the teacher-forced reference, the eager synchronous
              step token for token; (b) int8 at MOE_LAYERS on the dense
              cache (max_batch 6): a 1500-token prompt in 3 chunks through
              the cached flash and 5 short prompts through the flash
              forward, the decode kernel's split design at G = 4, each 32
              launches a layer, the same checks, the peak while serving;
              (c) 2 layers at full width written by tools/ckpt_writer.py
              as a Mixtral HF directory (6.33 GB of bf16) and served by
              serve.main --model with int4 quantized at load, layer by
              layer: every tensor bit for bit the writer's model quantized,
              the load's seconds and its peak above the quantized model
              (at most a dense layer's experts + 2 GiB), 2 requests by the
              reference; (d) train.main on (c)'s directory, LoRA r16 on wq,
              wv and the expert-routed w_gate/w_up/w_down, 2 x 512, 3
              steps (capacity 160 an expert): finite losses, each layer's
              moe_aux, the flash forward and backward launches, and before
              it one step's gradients through the kernels against the
              plain attention by the train phase's rule. With profile, a
              400-token prefill and a full batch's step of (a) and (b)
              under torch.profiler;
  serve-disagg disaggregated prefill/decode (serve/disagg.py) through
              serve.main at llama2-7b's full width, DISAGG_LAYERS (8) of
              its 32 layers written as an HF directory, int4 weights
              (seed 0, quantized at load) on the paged pool, max_batch 8,
              max_seq_len 2048:
              five child processes on the one card, a monolith (int8
              pages), a prefill tier on int8 pages, one on bf16 pages and
              two decode tiers on int8 pages, every tier's weights digest
              equal to this process's draw; (a) 8 concurrent greedy
              requests of 20-1500 tokens (the 1500 in 3 chunks) through the
              int8 pair, every token the monolith's (read from each
              request's journey on /debug/requestz: the decode segment's
              emits under the request's trace id), each handoff's pages,
              bytes, export and staging ms and GB/s, the sends'
              kv_transfer_seconds; (b) the bf16 pool's pages quantized into
              the int8 pools, every token by the 5% rule against a
              single-shot forward; the client TTFT through the pair beside
              the monolith's (20, 520 and 1500 tokens, one at a time); the
              send's encode and loopback socket timed in this process; each
              tier's int4 launches by design (a decode tier never
              prefills); (c) the decode tier holding a stream SIGKILLed
              after 3 tokens: the request is requeued, the survivor streams
              the rest, each token the monolith's; the inter-token gaps of
              6 streams while two 1500-token prompts arrive, the pair (one
              decode tier left) and the monolith in turns; then the last
              decode tier killed: the stream ends "error" within the ship
              timeout + 5 s;
  serve-w8a8  quantize: w8a8 through serve.main at llama2-7b's full width
              and depth, serve-int4's params and prompts otherwise (the
              dense int8 cache, fused decode, max_seq_len 2048): int8
              weights and per-token int8 activations, every projection
              but wo and the lm_head of every forward one launch of the
              quantize kernel (csrc/w8a8_quantize.cu) and one of the s8
              matmul (csrc/w8a8_matmul.cu), (6 x 32 + 1) x forwards, a
              replay holding as many; every served greedy token against a
              single-shot w8a8 forward (5% rule), the eager synchronous
              step token for token, the graph checks, the bytes on the
              card; the decode step beside weight-only int8 on the same
              weights (quant_activations off), in turns. The kernels
              phase holds both kernels at M = 1, 8 and 512 over
              llama2-7b's (C, N) of wq, w_gate, w_down, the lm_head and
              mixtral's expert w_gate: the int8 rows and scales, the s32
              sums and the bf16 output bit for bit their plain versions
              (float64 over the int8 values for the product), a dropped
              K tile rejected by the row limit; the yardsticks
              torch._int_mm (M padded to 32) and torch.matmul over the
              dequantized bf16 weight;
  rl          the RL loop (substratus_tpu_torch/rl/) at llama2-7b's width,
              4 layers, bf16, full finetuning: one actor engine (the
              default: overlapped, paged, the step a graph) and the
              learner on the card, 16 prompts of 16-64 tokens, 32 tokens
              at temperature 0.9, 3 rounds of 2 updates (8 x 96): every
              prompt an episode, no generation error, weights_version 1,
              2, 3, finite losses, the actor's weights the learner's
              snapshot after each swap and a greedy probe through it
              within the 5% rule of a single-shot forward of them; the
              scheduler thread never restarted, no graph captured again;
              each round's generation seconds and tokens/s, learn,
              snapshot and swap seconds, the peak bytes. With profile,
              one more round under torch.profiler;
  serve-gang  a tensor-parallel gang (parallel/, serve/multihost.py): two
              ranks of tensor=2 on the one card, gloo, at llama2-7b's width
              and GANG_LAYERS layers written as an HF directory (each rank
              loads its shard a layer at a time): (a) serve.main x 2 under
              the operator's gang environment, bf16, dense, 8 concurrent
              greedy requests of 64-1500 tokens (the longest chunked), 64
              new each, every served token (from the leader's journeys)
              within the near-tie rule of a single-process single-shot
              forward, the flash, cached flash and decode kernels at 16
              heads a rank counted on the leader, then SIGTERM to the
              leader ends both ranks with 0; (b) tools/gang_worker.py as
              both ranks over the same requests with one sampled row:
              both ranks' tokens equal; gloo's all-reduce of CUDA bf16
              tensors at [8,1,4096] and [1,512,4096], the event
              broadcast's time, the decode step and TTFT in turns with a
              single process on the same weights (single, gang, single),
              each rank's peak memory; (c) paged with int8 weights, 4
              requests sharing a prefix, by the same rule, then a SIGKILLed
              follower makes the leader exit non-zero within its printed
              collective timeout; (d) the llama2-70b example's serving gang
              as written (examples/llama2-70b/server.yaml's params: int4,
              int8 cache, max_batch 32, the paged pool) with tensor 2 for
              16: four serve.main ranks on the one card, data=2 x tensor=2,
              llama2-70b at full width and GANG_70B_LAYERS layers written
              as an HF directory (each rank quantizes and slices its
              shard a layer at a time), 8 concurrent requests of 64-960
              tokens, half sharing a 256-token prefix, 48 new each: every
              served token within the near-tie rule of a single-process
              teacher-forced int4 forward on the same bytes, a prefix hit
              on each data replica, the int4 kernels' launches on the
              leader, then a SIGKILL to a rank of the other data replica
              makes the leader exit non-zero within its collective
              timeout; then four gang_worker ranks on the same directory
              and requests, in turns with a single process (single, gang,
              single): the ranks' tokens equal, the decode step and TTFT,
              the data exchange's and the int32 all-reduce's medians, each
              rank's peak memory; (e) w8a8 in a gang: two gang_worker
              ranks at llama2-7b's width (tensor=2, dense, 8 rows, one
              sampled): both ranks' tokens equal, every greedy token by
              the rule against a single-process w8a8 forward, the
              row-parallel w_down's two w8a8_quantize modes counted;
              (f)-(h) in one gang_worker call of five legs, two ranks of
              tensor=2 at GANG_LAYERS: (f) examples/llama2-7b/
              server-throughput.yaml's params (int4, int8 cache, B=24,
              prompt lookup k=3) on the paged pool as written, then on the
              dense cache (the cached flash carries every verify wider
              than one token at 16 heads a rank: launched L x verify
              passes), 24 requests (two sampled), 48 new each: both
              ranks' tokens equal, verify passes above 0, acceptance,
              every greedy token within the rule of a single-process int4
              forward, the round's host clock in turns with a
              single-process spec engine (single, gang, single); (g) bf16
              pages with a draft at tinyllama-1.1b's width and
              GANG_DRAFT_LAYERS layers written as an HF directory, sharded
              at tensor 2, k=4; (h) three seeded tenants of rank 16
              (capacity 2) with base rows, t0 and t1 in one batch and t2
              hot-loaded mid-run (an eviction), on bf16 pages and on int4
              (w_down row-parallel in whole groups) over the dense int8
              cache: both ranks' tokens and stores equal, t0 and t1
              different, every token within the rule of a single-shot
              forward with the row's adapter; (i) serve.batchgen as two
              ranks under examples/batch-generation's params (int8,
              max_batch 16) with tensor 2, 32 records of 32 tokens: the
              follower SIGKILLed once a record is durable makes the leader
              exit non-zero, the rerun resumes, every record written once
              with tokens within the rule of a single-process int8
              forward; (e) runs as a sixth leg of (f)-(h)'s call;
  serve-gang-data
              (only when named) (f)'s paged leg as four gang_worker ranks
              of data=2 x tensor=2 on the one card: each replica verifies
              its 12 rows and exchanges the round's choices and samples
              [24, w+1] with the other; the four ranks' tokens equal (the
              sampled rows too), every greedy token within the rule of a
              single-process int4 forward, the exchange's median and the
              round's host clock;
  profile     (only when named) host-clock prefill and decode-step times
              (the overlapped graph replays) and, under torch.profiler,
              their device busy time and top kernels, after serve
              (prompts of 16 and 400 tokens) and after serve-long (40 and
              3000 tokens, the slots filled at 1000; the decode steps also
              unfused, in turns with the fused ones, each impl's own graph)
              and after serve-int4 (16 and 1500 tokens), and after
              serve-paged's legs (a) (16 and 512 tokens; before it a
              512-token prompt's prefill without a prefix hit and again
              with 496 tokens hit) and (c) (16 and 1500 tokens), the
              prefix cache off so that each prefill runs in full, with the int4
              matmul's and the GEMMs' share of the device time (a decode
              step of serve-int4 must run no split-K sums of
              q4_matmul.cu); after
              train and train-full, one more step under torch.profiler:
              its device busy time and top kernels.

The line before the last is one JSON object with every kernel's numbers
(launches from the serve or train phase whose path runs the kernel, with
serve-spec's, serve-surface's, serve-families', serve-adapters',
serve-moe's and serve-disagg's beside; the
int4 matmul's three designs are three entries, q4_matmul.cu's with no
launch on the main path, and the cached flash's int8 route another; the
two w8a8 kernels replace no TPU kernel and name the XLA ops of JAX's
qeinsum_w8a8 they replace, with serve-w8a8's launches); the
last line
is {"ok": true, "device": {...}}. Details go to chip_smoke.json in OUT_DIR.
Nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import math
import queue
import random
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
WATCHDOG_S = 1100  # of the default run's 1200 s limit
# bf16 tolerance: the kernel and the plain version round p (flash) and the
# output to bf16 after summing in another order, so they differ by about
# one bf16 ulp of values of order 1 (2^-7 to 2^-6).
BF16_ATOL = 2e-2
LSE_ATOL = 1e-3  # f32 row logsumexp, summed in another order
# The flash backward against its plain version, per output vector (see
# row_rel_err): both round p, ds and the outputs to bf16 at the same places
# and differ in f32 summation order, so most outputs are bit-equal and a
# rounding flip moves a vector by at most one bf16 ulp of one term (2^-8 to
# 2^-7 of a key with a single query). A dropped tile moves whole vectors.
# The int4 matmul per output row likewise: both sides multiply the same
# bf16 weights and differ in the f32 summation order and the output's bf16
# rounding (2^-8 relative); a dropped scale group moves every row by about
# 0.18 of its norm at C = 4096, a dropped row tile its rows by all of it.
# The flash forward and the cached flash likewise (p and the output rounded
# to bf16 at the same places): a dropped k-tile moves the rows that attend
# it by about its share of their softmax, a zeroed q-tile its rows by all.
ROW_REL = 2**-6
KT_WGMMA = 128  # keys of a bf16 K/V tile of csrc/flash_fwd_wgmma.cu (an int8 cache's tiles hold 64)


def fail(msg: str) -> None:
    """Exit 1 with `msg` on both streams (standard error's tail is what a
    refused run's report shows)."""
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 25, flush=None, hold: bool = False) -> float:
    """Median of n launches, each between two CUDA events, after a warm-up;
    flush() runs before each launch, outside the events, followed by a spin
    on the card that holds the start event back until the host has
    enqueued fn (the int4 wrapper's Python took 45-112 us a call on the
    card's host, more than the flush's 80 us: its launch time was counted).
    hold: the spin alone, for calls whose device time is shorter than the
    host time of their wrapper (the flash kernels at serving shapes, SDPA),
    so that the events time the card and not the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if flush is not None:
            flush()
        if flush is not None or hold:
            torch.cuda._sleep(500_000)  # clock cycles, about 0.3 ms
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# --- kernels against their plain versions -------------------------------------


def host_time_us(call, n: int = 50) -> float:
    """Host time of one call of a C entry point (it enqueues and returns)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    out = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return out


def in_turns(calls: dict, rounds: int = 2, flush=None) -> dict:
    """Each call's time_ms (hold; flush before each launch where given) in
    turns: a b b a for two calls."""
    times = {name: [] for name in calls}
    order = list(calls)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            times[name].append(time_ms(calls[name], flush=flush, hold=True))
    return times


def planted_faults(label: str, ref, dropped, s: int) -> list:
    """Row errors of planted faults against ref: `dropped` (the plain
    output without the design's last live k-tile) and, at a ragged length
    s, ref with its last 64-row q-tile (one consumer warpgroup's) zeroed.
    Fails unless ROW_REL rejects each."""
    faults = [row_rel_err(dropped, ref)]
    if s % 64:
        tile = ref.clone()
        tile[:, 64 * ((s - 1) // 64):] = 0
        faults.append(row_rel_err(tile, ref))
    if min(faults) <= ROW_REL:
        fail(f"{label}: the limit {ROW_REL} accepts a planted fault (row errors {faults})")
    return faults


def flash_case(gen, b, s, h, kh, causal, d=128, compare=False):
    """The forward against its plain version on the same q, k, v: max-abs
    and per output vector (row_rel_err <= ROW_REL), the LSE within
    LSE_ATOL; the call must launch the design flash_fwd_design names, and
    the limit must reject the planted faults (the output without the
    design's last live k-tile; at a ragged S its last q-tile zeroed).
    Its library call is SDPA on views of q, k, v, as in every other case;
    library_contiguous_ms SDPA on [B, H, S, D] copies made outside the
    timing (the yardstick of this case's earlier readings).
    compare (the main shapes): the design's kernel timed in turns with
    flash_fwd.cu's (the mma design, called through its C entry point
    at this head_dim as a measurement), and each C entry point's host time
    a call. Times hold the card (time_ms)."""
    import torch
    import torch.nn.functional as F

    from substratus_tpu_torch import kernels
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain, flash_fwd_design
    from substratus_tpu_torch.ops.headdim import padded_head_dim

    dev = "cuda"
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kh, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kh, d), generator=gen, device=dev).to(torch.bfloat16)
    dp = padded_head_dim(d)
    design = flash_fwd_design(dp)
    before = {x: getattr(flash_attention, f"launches_{x}") for x in ("wgmma", "mma", "padded")}
    out, lse = flash_attention(q, k, v, causal, return_lse=True)
    launched = {x: getattr(flash_attention, f"launches_{x}") - n for x, n in before.items()}
    ref, ref_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    label = f"flash b{b} s{s} h{h}/{kh} d{d} causal={causal}"
    if launched != {x: int(x == design or (x == "padded" and dp != d)) for x in launched}:
        fail(f"{label}: launches {launched}, want one of the {design} design{' at the padded route' * (dp != d)}")
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    lse_err = (lse - ref_lse).abs().max().item()
    if not (torch.isfinite(out.float()).all() and err <= BF16_ATOL and rel <= ROW_REL and lse_err <= LSE_ATOL):
        fail(f"{label}: max|err| {err} (tol {BF16_ATOL}), row error {rel} (limit {ROW_REL}), "
             f"lse {lse_err} (tol {LSE_ATOL})")
    cut = KT_WGMMA * ((s - 1) // KT_WGMMA)  # the design's last k-tile: keys cut..s-1
    dropped = (flash_attention_plain(q, k[:, :cut], v[:, :cut], causal) if cut else torch.zeros_like(ref))
    faults = planted_faults(label, ref, dropped, s)
    # SDPA on views of the same q, k, v, as every other case's library call
    # (library_ms); beside it on head-major copies made outside the timing.
    views = tuple(x.transpose(1, 2) for x in (q, k, v))
    copies = tuple(x.contiguous() for x in views)
    gqa = {"enable_gqa": True} if h != kh else {}
    pairs = s * (s + 1) // 2 if causal else s * s
    b_ms, by = bound(2 * (2 * b * s * h * d + 2 * b * s * kh * d), 4 * d * h * b * pairs)
    case = {
        "case": f"B={b} S={s} H={h} KH={kh} D={d}{f' (padded to {dp})' * (dp != d)} causal={causal}",
        "design": design, "max_abs_err": err, "lse_max_abs_err": lse_err, "tol": BF16_ATOL, "row_rel_err": rel,
        "fault_row_rel_err": min(faults),
        "ms": time_ms(lambda: flash_attention(q, k, v, causal), hold=True),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, causal), n=5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(*views, is_causal=causal, **gqa), hold=True),
        "library_contiguous_ms": time_ms(
            lambda: F.scaled_dot_product_attention(*copies, is_causal=causal, **gqa), hold=True),
        "bound_ms": b_ms, "bound_by": by,
    }
    if compare:
        lib, o2 = kernels.library(), torch.empty_like(q)
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(), None, b, s, s, h, kh, d,
                kernels.DTYPE_CODES[q.dtype], d**-0.5, int(causal))
        stream = kernels.stream_ptr(q.device)
        calls = {"wgmma": lambda: kernels.check(lib.flash_fwd_wgmma(*head, stream), "flash_fwd_wgmma"),
                 "mma": lambda: kernels.check(lib.flash_fwd(*head, stream), "flash_fwd")}
        case.update(turns_ms=in_turns(calls), host_us={name: host_time_us(call) for name, call in calls.items()})
    return case


def laid_out(t, rows: int, d: int):
    """A [B, KH, S, D] cache (or its [B, KH, S] scales: d None) with zero
    rows and columns appended up to the layout of cache_layout."""
    import torch.nn.functional as F

    if t is None:
        return None
    pad = (0, rows - t.shape[2]) if d is None else (0, d - t.shape[3], 0, rows - t.shape[2])
    return F.pad(t, pad).contiguous()


def decode_case(gen, b, s, h, kh, int8, positions, d=128, compare=False):
    """Single-token decode attention against its plain version at
    `positions`: the call must launch the design decode_design names; held
    by max-abs and per output vector (row_rel_err <= ROW_REL), a limit
    that must reject the planted fault (the plain output without each
    slot's last live split of decode_split_plan's rows). The kernel reads
    the cache as cache_layout lays it out (a head dim not built padded to
    the next built one, the rows of an int8 cache for the split design at
    a group it alone takes rounded up to a multiple of 4; positions inside
    the s rows), the plain version the s rows at the true D. compare: the
    design's kernel timed in turns with decode_attn.cu's (the rows design,
    called through its C entry point), and each C entry point's host time
    a call. The kernel and SDPA are timed with the card held (time_ms)."""
    import torch
    import torch.nn.functional as F

    from substratus_tpu_torch import kernels
    from substratus_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from substratus_tpu_torch.ops.fused_decode import (
        cache_layout, decode_design, decode_split_plan, group_slices, sm_count, split_workspace)
    from substratus_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, kh, s, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, kh, s, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    ks = vs = None
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    sc, dc = cache_layout(d, s, int8, h // kh)
    padded = (sc, dc) != (s, d)
    if padded and max(positions) >= s:
        fail(f"decode case at a laid-out cache: positions {positions} reach past its {s} rows")
    kc, vc = (laid_out(t, sc, dc) if padded else t for t in (k, v))
    ksc, vsc = (laid_out(t, sc, None) if padded else t for t in (ks, vs))
    design = decode_design(dc, sc, int8, h // kh)
    before = {x: getattr(decode_attention, f"launches_{x}") for x in ("split", "rows", "padded")}
    out = decode_attention(q, kc, vc, pos, ksc, vsc)
    launched = {x: getattr(decode_attention, f"launches_{x}") - n for x, n in before.items()}
    ref = decode_attention_plain(q, k, v, pos, ks, vs)
    torch.cuda.synchronize()
    label = f"decode b{b} s{s} h{h}/{kh} d{d} int8={int8}"
    if launched != {x: int(x == design or (x == "padded" and dc != d)) for x in launched}:
        fail(f"{label}: launches {launched}, want one of the {design} design at the cache's head dim {dc}")
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    if not (torch.isfinite(out.float()).all() and err <= BF16_ATOL and rel <= ROW_REL):
        fail(f"{label}: max|err| {err} (tol {BF16_ATOL}), row error {rel} (limit {ROW_REL})")
    if not torch.all(out[pos < 0] == 0):
        fail(f"{label}: a slot before the cache (pos < 0) is not exactly 0")
    # The planted fault: each slot without its last live split (rows from
    # cut on), i.e. attending rows 0..cut-1.
    n_split, rows = decode_split_plan(s, b * kh * group_slices(h // kh)[1], sm_count(0))
    live = [0 if p < 0 else min(p + 1, s) for p in positions]
    cut = torch.tensor([rows * ((n - 1) // rows) - 1 if n else -1 for n in live], dtype=torch.int32, device=dev)
    fault = row_rel_err(decode_attention_plain(q, k, v, cut, ks, vs), ref)
    if fault <= ROW_REL:
        fail(f"{label}: the limit {ROW_REL} accepts a planted fault (row error {fault})")
    n_rows = sum(live)  # cache rows the data needs
    elem = 1 if int8 else 2
    nbytes = 2 * b * h * d * 2 + 2 * n_rows * kh * d * elem + (2 * n_rows * kh * 4 if int8 else 0) + 4 * b
    b_ms, by = bound(nbytes, 4 * d * n_rows * kh * (h // kh))
    library_ms = None
    if not int8:  # no PyTorch call takes an int8 cache with per-row scales
        qt = q.transpose(1, 2)
        mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
        gqa = {"enable_gqa": True} if h != kh else {}
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, **gqa), hold=True)
    if padded:  # the plan of the laid-out cache, the kernel's
        n_split, rows = decode_split_plan(sc, b * kh * group_slices(h // kh)[1], sm_count(0))
    case = {
        "case": f"B={b} S={s} H={h} KH={kh} D={d} {'int8' if int8 else 'bf16'} pos={positions}"
                + (f" (cache laid out {sc} x {dc})" if padded else ""), "design": design,
        "plan": [n_split, rows], "max_abs_err": err, "tol": BF16_ATOL, "row_rel_err": rel, "fault_row_rel_err": fault,
        "ms": time_ms(lambda: decode_attention(q, kc, vc, pos, ksc, vsc), hold=True),
        "plain_ms": time_ms(lambda: decode_attention_plain(q, k, v, pos, ks, vs), n=5),
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
    }
    if compare:
        lib, o2 = kernels.library(), torch.empty_like(q)
        _, _, ws = split_workspace(q, b, kh, s)
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr() if int8 else None,
                vs.data_ptr() if int8 else None, pos.data_ptr(), o2.data_ptr())
        dims = (b, h, kh, s, d, kernels.DTYPE_CODES[k.dtype], d**-0.5)
        stream = kernels.stream_ptr(q.device)
        ws_ptr = ws.data_ptr() if ws is not None else None
        calls = {"split": lambda: kernels.check(lib.decode_split(*head, ws_ptr, *dims, rows, n_split, stream),
                                                "decode_split"),
                 "rows": lambda: kernels.check(lib.decode_attn(*head, *dims, stream), "decode_attn")}
        case.update(turns_ms=in_turns(calls), host_us={name: host_time_us(call) for name, call in calls.items()})
    return case


def cached_case(gen, h, kh, int8, limit_row=False, b=1, sq=512, sk=4096, start=2048, d=128, compare=False,
                starts=None):
    """A chunk of sq queries at positions start.. against an sk-row cache
    (the fifth 512-token chunk of a long prompt by default); with `starts`
    each row's own first position (a verify round: rows at S-1 are idle
    slots, whose later positions lie past the cache). limit_row:
    kv_length clips the chunk and the first row's position is -1, so that
    row's limit is -1 and its output must be exactly 0. Held as
    flash_case holds the forward: the design flash_cached_design names,
    max-abs and per output vector, planted faults (without the design's
    last live k-tile; at a ragged sq its last q-tile zeroed); compare:
    timed in turns with flash_cached.cu's kernel (the mma design) and
    each C entry point's host time a call (int8 included: no PyTorch call
    takes an int8 cache)."""
    import torch
    import torch.nn.functional as F

    from substratus_tpu_torch import kernels
    from substratus_tpu_torch.ops.flash_attention import (
        flash_cached_attention, flash_cached_attention_plain, flash_cached_design)
    from substratus_tpu_torch.ops.headdim import padded_head_dim
    from substratus_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, kh, sk, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, kh, sk, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = (start + torch.arange(sq, device=dev)).repeat(b, 1).to(torch.int32)
    if starts is not None:
        pos = (torch.tensor(starts, device=dev)[:, None] + torch.arange(sq, device=dev)[None, :]).to(torch.int32)
    kv_len = None
    if limit_row:
        pos[:, 0] = -1
        kv_len = torch.full((b,), start + sq // 2, dtype=torch.int32, device=dev)
    ks = vs = None
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    dp = padded_head_dim(d)  # the cache as the engine lays it out: zero columns up to a built head dim
    design = flash_cached_design(dp)
    args = (q, k, v, pos, ks, vs, kv_len)
    kernel_args = (q, laid_out(k, sk, dp), laid_out(v, sk, dp), pos, ks, vs, kv_len) if dp != d else args
    before = {x: getattr(flash_cached_attention, f"launches_{x}") for x in ("wgmma", "mma", "padded")}
    out = flash_cached_attention(*kernel_args)
    launched = {x: getattr(flash_cached_attention, f"launches_{x}") - n for x, n in before.items()}
    ref = flash_cached_attention_plain(*args)
    torch.cuda.synchronize()
    label = f"flash_cached sq{sq} h{h}/{kh} d{d} int8={int8} limit_row={limit_row}"
    if launched != {x: int(x == design or (x == "padded" and dp != d)) for x in launched}:
        fail(f"{label}: launches {launched}, want one of the {design} design{' at the padded route' * (dp != d)}")
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    if not (torch.isfinite(out.float()).all() and err <= BF16_ATOL and rel <= ROW_REL):
        fail(f"{label}: max|err| {err} (tol {BF16_ATOL}), row error {rel} (limit {ROW_REL})")
    if limit_row and not torch.all(out[:, 0] == 0):
        fail("flash_cached: a row with limit -1 is not exactly 0")
    limit = pos.long() if kv_len is None else torch.minimum(pos.long(), kv_len.long()[:, None] - 1)
    live_cols = (limit.clamp(min=-1) + 1).clamp(max=sk)  # [B, Sq]
    kt = KT_WGMMA if design == "wgmma" and not int8 else 64  # keys of the design's k-tile (int8: 64)
    cut = kt * ((int(live_cols.max()) - 1) // kt)  # its last live k-tile: cache rows cut..
    short = [t[:, :, :cut].contiguous() if t is not None else None for t in (k, v, ks, vs)]
    dropped = (flash_cached_attention_plain(q, short[0], short[1], pos, short[2], short[3], kv_len) if cut
               else torch.zeros_like(ref))
    faults = planted_faults(label, ref, dropped, sq)
    rows = int(live_cols.amax(dim=1).sum())  # cache rows the blocks must read
    elem = 1 if int8 else 2
    nbytes = 2 * b * sq * h * d * 2 + 2 * rows * kh * d * elem + (2 * rows * kh * 4 if int8 else 0) + 4 * b * sq
    b_ms, by = bound(nbytes, 4 * d * h * int(live_cols.sum()))
    library_ms = None
    if not int8:  # no PyTorch call takes an int8 cache with per-row scales
        qt = q.transpose(1, 2)
        mask = (torch.arange(sk, device=dev)[None, None, :] <= limit[:, :, None])[:, None]
        gqa = {"enable_gqa": True} if h != kh else {}
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, **gqa), hold=True)
    case = {
        "case": f"B={b} Sq={sq} Sk={sk} H={h} KH={kh} D={d}{f' (cache at {dp})' * (dp != d)} "
                f"{'int8' if int8 else 'bf16'} "
                + (f"pos {start}..{start + sq - 1}" if starts is None else f"rows from {min(starts)}..{max(starts)}")
                + f"{' kv_length, one row at limit -1' if limit_row else ''}",
        "design": design, "max_abs_err": err, "tol": BF16_ATOL, "row_rel_err": rel, "fault_row_rel_err": min(faults),
        "ms": time_ms(lambda: flash_cached_attention(*kernel_args), hold=True),
        "plain_ms": time_ms(lambda: flash_cached_attention_plain(*args), n=5),
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
    }
    if compare:
        lib, o2 = kernels.library(), torch.empty_like(q)
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr() if int8 else None,
                vs.data_ptr() if int8 else None, pos.data_ptr(), kv_len.data_ptr() if kv_len is not None else None,
                o2.data_ptr(), b, sq, sk, h, kh, d, kernels.DTYPE_CODES[k.dtype], d**-0.5,
                kernels.stream_ptr(q.device))
        calls = {"wgmma": lambda: kernels.check(lib.flash_cached_wgmma(*head), "flash_cached_wgmma"),
                 "mma": lambda: kernels.check(lib.flash_cached(*head), "flash_cached")}
        case.update(turns_ms=in_turns(calls), host_us={name: host_time_us(call) for name, call in calls.items()})
    return case


def fused_case(gen, h, kh, int8, positions, b=8, s=4096, d=128, compare=False):
    """The fused cache write + decode attention at decode positions spread
    over the cache, held as decode_case holds decode attention (the design
    decode_design names; max-abs and per output vector; the planted fault
    each slot without its last live split of history rows). After the
    launch the cache row at pos must be the new row and no other row may
    have moved. Also timed: the unfused path for the same work (the row
    writes of update_cache_and_attend plus the decode kernel). compare:
    timed in turns with fused_decode.cu's kernel (the rows design), and
    each C entry point's host time a call."""
    import torch
    import torch.nn.functional as F

    from substratus_tpu_torch import kernels
    from substratus_tpu_torch.ops.decode_attention import _write_rows, decode_attention, decode_attention_plain
    from substratus_tpu_torch.ops.fused_decode import (
        cache_layout, decode_design, decode_split_plan, fused_decode_attention, fused_decode_attention_plain,
        group_slices, sm_count, split_workspace)
    from substratus_tpu_torch.ops.headdim import pad_head
    from substratus_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(torch.bfloat16)
    nk, nv = (torch.randn((b, kh, 1, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    ck, cv = (torch.randn((b, kh, s, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    pos2 = pos.long()[:, None]
    rows = (torch.arange(b, device=dev)[:, None], torch.arange(kh, device=dev)[None, :], pos2)
    scales = ()
    if int8:
        (nk, nks), (nv, nvs), (ck, cks), (cv, cvs) = map(quantize_kv, (nk, nv, ck, cv))
        nks, nvs, cks, cvs = nks[..., 0], nvs[..., 0], cks[..., 0].contiguous(), cvs[..., 0].contiguous()
        cks[rows], cvs[rows] = nks[..., 0], nvs[..., 0]  # the caller's scale writes
        scales = (nks, nvs, cks, cvs)
    # The kernel's caches as cache_layout lays them out (zero columns and
    # rows where the head dim or the design asks), the fresh rows padded
    # as update_cache_and_attend pads them; the plain version's at s x d.
    sc, dc = cache_layout(d, s, int8, h // kh)
    padded = (sc, dc) != (s, d)
    if padded and max(positions) >= s:
        fail(f"fused case at a laid-out cache: positions {positions} reach past its {s} rows")
    design = decode_design(dc, sc, int8, h // kh)
    kc, vc = (laid_out(t, sc, dc) for t in (ck, cv))
    kp, vp = ck.clone(), cv.clone()
    k_scales = (scales[0], scales[1], laid_out(scales[2], sc, None), laid_out(scales[3], sc, None)) if int8 else ()
    nkc, nvc = pad_head(nk, dc), pad_head(nv, dc)
    before = {x: getattr(fused_decode_attention, f"launches_{x}") for x in ("split", "rows", "padded")}
    out, _, _ = fused_decode_attention(q, nkc, nvc, kc, vc, pos, *k_scales)
    launched = {x: getattr(fused_decode_attention, f"launches_{x}") - n for x, n in before.items()}
    ref, _, _ = fused_decode_attention_plain(q, nk, nv, kp, vp, pos, *scales)
    torch.cuda.synchronize()
    label = f"fused_decode b{b} s{s} h{h}/{kh} d{d} int8={int8}"
    if launched != {x: int(x == design or (x == "padded" and dc != d)) for x in launched}:
        fail(f"{label}: launches {launched}, want one of the {design} design at the cache's head dim {dc}")
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    if not (torch.isfinite(out.float()).all() and err <= BF16_ATOL and rel <= ROW_REL):
        fail(f"{label}: max|err| {err} (tol {BF16_ATOL}), row error {rel} (limit {ROW_REL})")
    if not (torch.equal(kc[rows][..., :d], nk[:, :, 0]) and torch.equal(vc[rows][..., :d], nv[:, :, 0])
            and torch.equal(kc[:, :, :s, :d], kp) and torch.equal(vc[:, :, :s, :d], vp)
            and not kc[..., d:].any() and not kc[:, :, s:].any()):
        fail(f"{label}: the cache row at pos is not the new row, or another row or a padding moved")
    # The planted fault: each slot's history without its last live split
    # (rows from cut on): the current token placed at row cut of a copy and
    # attended with rows 0..cut-1 by the plain decode attention.
    n_split, split_rows = decode_split_plan(s, b * kh * group_slices(h // kh)[1], sm_count(0))
    cut = torch.tensor([split_rows * ((p - 1) // split_rows) if p > 0 else 0 for p in positions], device=dev)
    at_cut = (rows[0], rows[1], cut[:, None])
    kf, vf = kp.clone(), vp.clone()
    kf[at_cut], vf[at_cut] = nk[:, :, 0], nv[:, :, 0]
    ksf = vsf = None
    if int8:
        ksf, vsf = cks.clone(), cvs.clone()
        ksf[at_cut], vsf[at_cut] = nks[..., 0], nvs[..., 0]
    fault = row_rel_err(decode_attention_plain(q, kf, vf, cut, ksf, vsf), ref)
    if fault <= ROW_REL:
        fail(f"{label}: the limit {ROW_REL} accepts a planted fault (row error {fault})")
    hist = sum(positions)  # history rows 0..pos-1 the kernel must read
    elem = 1 if int8 else 2
    nbytes = (2 * b * h * d * 2 + 2 * hist * kh * d * elem + (2 * hist * kh * 4 if int8 else 0)
              + 2 * 2 * b * kh * d * elem + (2 * b * kh * 4 if int8 else 0) + 4 * b)
    b_ms, by = bound(nbytes, 4 * d * h * (hist + b))
    ks_c, vs_c = (k_scales[2], k_scales[3]) if int8 else (None, None)

    def unfused():
        _write_rows(kc, nkc, pos2)
        _write_rows(vc, nvc, pos2)
        if int8:
            _write_rows(ks_c, scales[0], pos2)
            _write_rows(vs_c, scales[1], pos2)
        decode_attention(q, kc, vc, pos, ks_c, vs_c)

    library_ms = None
    if not int8:
        qt = q.transpose(1, 2)
        mask = (torch.arange(s, device=dev)[None, :] <= pos2)[:, None, None, :]
        gqa = {"enable_gqa": True} if h != kh else {}
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kp, vp, attn_mask=mask, **gqa), hold=True)
    if padded:  # the plan of the laid-out cache, the kernel's
        n_split, split_rows = decode_split_plan(sc, b * kh * group_slices(h // kh)[1], sm_count(0))
    case = {
        "case": f"B={b} S={s} H={h} KH={kh} D={d} {'int8' if int8 else 'bf16'} pos={positions}"
                + (f" (cache laid out {sc} x {dc})" if padded else ""), "design": design,
        "plan": [n_split, split_rows], "max_abs_err": err, "tol": BF16_ATOL, "row_rel_err": rel,
        "fault_row_rel_err": fault,
        "ms": time_ms(lambda: fused_decode_attention(q, nkc, nvc, kc, vc, pos, *k_scales), hold=True),
        "plain_ms": time_ms(lambda: fused_decode_attention_plain(q, nk, nv, kp, vp, pos, *scales), n=5),
        "unfused_ms": time_ms(unfused, hold=True), "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
    }
    if compare:
        lib, o2 = kernels.library(), torch.empty_like(q)
        _, _, ws = split_workspace(q, b, kh, s)
        sp = [x.data_ptr() for x in scales] if int8 else [None] * 4
        head = (q.data_ptr(), nk.data_ptr(), nv.data_ptr(), sp[0], sp[1], kc.data_ptr(), vc.data_ptr(), sp[2], sp[3],
                pos.data_ptr(), o2.data_ptr())
        dims = (b, h, kh, s, d, kernels.DTYPE_CODES[kc.dtype], d**-0.5)
        stream = kernels.stream_ptr(q.device)
        ws_ptr = ws.data_ptr() if ws is not None else None
        calls = {"split": lambda: kernels.check(
                     lib.fused_decode_split(*head, ws_ptr, *dims, split_rows, n_split, stream), "fused_decode_split"),
                 "rows": lambda: kernels.check(lib.fused_decode(*head, *dims, stream), "fused_decode")}
        case.update(turns_ms=in_turns(calls), host_us={name: host_time_us(call) for name, call in calls.items()})
    return case


def q4_case(gen, m, n, c=4096, heads=None, compare=False):
    """x [m, c] bf16 times a random weight [c, n] quantized by quantize4
    as the model's own (heads: wo's [heads, c / heads, n] layout, groups
    along head_dim), the L2 flushed before each timed launch. The call
    must launch the design q4_design names (the per-design counters), and
    match the plain version within 1e-2 of its largest value and per output
    row within ROW_REL. For the wgmma and decode designs the limit must
    also reject planted faults built from the plain version: the output
    without its last scale group; at a ragged M (200), the output with its
    last 64-row tile zeroed (wgmma); the output without the groups of the
    plan's second split (decode, where the plan splits). compare (decode
    design): its C entry point timed in turns with q4_matmul.cu's
    (workspace and second launch included) at the same shape."""
    import torch

    from substratus_tpu_torch import kernels
    from substratus_tpu_torch.ops.fused_decode import sm_count
    from substratus_tpu_torch.ops.quant4 import (
        _mma_splits, cluster_capacity, q4_decode_plan, q4_design, q4_matmul, q4_matmul_plain, quantize4)

    dev = "cuda"
    shape, contracting = ((heads, c // heads, n), (0, 1)) if heads else ((c, n), (0,))
    qt = quantize4(torch.randn(shape, generator=gen, device=dev) * c**-0.5, contracting)
    packed, scale, block = qt.packed.reshape(c // 2, n), qt.scale.reshape(-1, n), qt.block
    x = torch.randn((m, c), generator=gen, device=dev).to(torch.bfloat16)
    design = q4_design(m, n, c, block)
    before = {d: getattr(q4_matmul, f"launches_{d}") for d in ("decode", "wgmma", "mma")}
    out = q4_matmul(x, packed, scale, block)
    launched = {d: getattr(q4_matmul, f"launches_{d}") - before[d] for d in before}
    ref = q4_matmul_plain(x, packed, scale, block)
    torch.cuda.synchronize()
    label = f"q4_matmul m{m} c{c} n{n} block {block}"
    if launched != {d: int(d == design) for d in launched}:
        fail(f"{label}: launches {launched}, want one of the {design} design")
    err = (out.float() - ref.float()).abs().max().item()
    # Both sides multiply the same bf16 weights: the output's bf16 rounding
    # (2^-8 relative) and the f32 summation order differ.
    tol = 1e-2 * ref.float().abs().max().item()
    rel = row_rel_err(out, ref)
    if not (torch.isfinite(out.float()).all() and err <= tol and rel <= ROW_REL):
        fail(f"{label}: max|err| {err} (tol {tol}), row error {rel} (limit {ROW_REL})")
    fault, plan = None, None
    if design in ("wgmma", "decode"):
        short = q4_matmul_plain(x[:, : c - block].contiguous(), packed[: (c - block) // 2], scale[:-1], block)
        faults = [row_rel_err(short, ref)]
        if design == "wgmma" and m == 200:
            tile = ref.clone()
            tile[64 * ((m - 1) // 64):] = 0
            faults.append(row_rel_err(tile, ref))
        if design == "decode":
            plan = q4_decode_plan(m, n, c, sm_count(0), cluster_capacity(0, 8 if m <= 8 else 16))
            g, splits = c // block, plan[1]
            if splits > 1:  # without split 1's groups
                keep = torch.ones(g, dtype=torch.bool, device=dev)
                keep[g // splits: 2 * g // splits] = False
                missing = q4_matmul_plain(x[:, keep.repeat_interleave(block)].contiguous(),
                                          packed[keep.repeat_interleave(block // 2)].contiguous(),
                                          scale[keep].contiguous(), block)
                faults.append(row_rel_err(missing, ref))
        fault = min(faults)
        if fault <= ROW_REL:
            fail(f"{label}: the limit {ROW_REL} accepts a planted fault (row errors {faults})")
    dense = qt.dequant(torch.bfloat16).reshape(c, n)
    l2 = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB, 5x the 50 MB L2

    def flush():  # a read: written lines would be written back inside the timed launch
        l2.sum()

    b_ms, by = bound(m * c * 2 + packed.numel() + 4 * scale.numel() + m * n * 2, 2 * m * c * n)
    case = {
        "case": f"M={m} C={c} N={n} block={block}{f' (wo, {heads} heads)' if heads else ''}", "design": design,
        "max_abs_err": err, "tol": tol, "row_rel_err": rel, "fault_row_rel_err": fault,
        "ms": time_ms(lambda: q4_matmul(x, packed, scale, block), flush=flush),
        "plain_ms": time_ms(lambda: q4_matmul_plain(x, packed, scale, block), n=5, flush=flush),
        "library_ms": time_ms(lambda: torch.matmul(x, dense), flush=flush),
        "bound_ms": b_ms, "bound_by": by,
    }
    if plan is not None:
        case["plan"] = list(plan)
    if compare:
        lib, stream = kernels.library(), kernels.stream_ptr(x.device)
        head = (x.data_ptr(), packed.data_ptr(), scale.data_ptr())
        o_decode, o_mma = torch.empty_like(out), torch.empty_like(out)
        splits = _mma_splits(m, n, c, block, 0)
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
        calls = {"decode": lambda: kernels.check(lib.q4_matmul_decode(*head, o_decode.data_ptr(), m, n, c, block,
                                                                      *plan, stream), "q4_matmul_decode"),
                 "q4_matmul.cu": lambda: kernels.check(lib.q4_matmul(*head, o_mma.data_ptr(), ws.data_ptr(), m, n, c,
                                                                     block, splits, stream), "q4_matmul")}
        turns = in_turns(calls, flush=flush)
        torch.cuda.synchronize()
        if row_rel_err(o_mma, ref) > ROW_REL or not torch.equal(o_decode, out):
            fail(f"{label}: the C entry points' outputs disagree with the wrapper's or the plain version")
        case["turns_ms"] = turns
    return case


INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak


def bound_int8(nbytes: float, ops: float):
    """bound() with the operations at the card's dense int8 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def yardstick_ms(fn, **kw):
    """time_ms of a library call timed as a yardstick only, or None (said
    on a line) where this PyTorch build refuses the call."""
    try:
        return time_ms(fn, **kw)
    except RuntimeError as e:
        print(f"yardstick refused: {str(e).splitlines()[0][:200]}", flush=True)
        return None


def w8a8_quantize_case(gen, m, c):
    """The per-token activation quantization (csrc/w8a8_quantize.cu) on bf16
    rows [m, c] (one row all zeros, one of huge values) against its plain
    version: int8 rows and f32 scales bit for bit. No single PyTorch call
    computes it (library null)."""
    import torch

    from substratus_tpu_torch.ops.quant import w8a8_quantize, w8a8_quantize_plain

    x = (torch.randn((m, c), generator=gen, device="cuda") * 3).to(torch.bfloat16)
    if m > 2:
        x[1] = 0
        x[2] *= 1e4
    before = w8a8_quantize.launches
    xq, ascale = w8a8_quantize(x)
    ref_q, ref_s = w8a8_quantize_plain(x)
    torch.cuda.synchronize()
    label = f"w8a8_quantize m{m} c{c}"
    if w8a8_quantize.launches != before + 1:
        fail(f"{label}: no launch counted")
    if not (torch.equal(xq, ref_q) and torch.equal(ascale, ref_s)):
        bad = (xq != ref_q).sum().item()
        fail(f"{label}: {bad} int8 values and {(ascale != ref_s).sum().item()} scales differ from the plain version")
    b_ms, by = bound_int8(3 * m * c + 4 * m, 0)
    return {"case": f"M={m} C={c}", "max_abs_err": 0.0, "tol": 0, "bit_exact": True,
            "ms": time_ms(lambda: w8a8_quantize(x), hold=True),
            "plain_ms": time_ms(lambda: w8a8_quantize_plain(x), n=5, hold=True),
            "library_ms": None, "bound_ms": b_ms, "bound_by": by}


def w8a8_rows_case(gen, m, c):
    """csrc/w8a8_quantize.cu's row-parallel modes on bf16 rows [m, c] (a
    rank's slice of w_down's input; one row all zeros): mode 1's row amax
    and mode 2's int8 values and scales from a given amax (1.75x the
    slice's, as another rank's larger maximum gives it) bit for bit their
    plain versions. Timed as the two launches of one row-parallel
    quantization (the all-reduce between them apart); no single PyTorch
    call computes it (library null)."""
    import torch

    from substratus_tpu_torch.ops.quant import w8a8_quantize, w8a8_quantize_scaled, w8a8_row_amax, w8a8_scaled_plain

    x = (torch.randn((m, c), generator=gen, device="cuda") * 3).to(torch.bfloat16)
    x[1 % m] = 0
    before = (w8a8_quantize.launches_amax, w8a8_quantize.launches_scaled)
    amax = w8a8_row_amax(x)
    wider = amax * 1.75
    xq, ascale = w8a8_quantize_scaled(x, wider)
    ref_amax = x.float().abs().amax(dim=-1, keepdim=True)
    ref_q, ref_s = w8a8_scaled_plain(x, wider)
    torch.cuda.synchronize()
    label = f"w8a8_quantize (row-parallel) m{m} c{c}"
    if (w8a8_quantize.launches_amax, w8a8_quantize.launches_scaled) != (before[0] + 1, before[1] + 1):
        fail(f"{label}: launches not counted")
    if not (torch.equal(amax, ref_amax) and torch.equal(xq, ref_q) and torch.equal(ascale, ref_s)):
        fail(f"{label}: {(amax != ref_amax).sum().item()} amax, {(xq != ref_q).sum().item()} int8 values and "
             f"{(ascale != ref_s).sum().item()} scales differ from the plain version")
    b_ms, by = bound_int8((2 * m * c + 4 * m) + (2 * m * c + 4 * m + m * c + 4 * m), 0)

    def plain():
        a = x.float().abs().amax(dim=-1, keepdim=True)
        return w8a8_scaled_plain(x, a)

    return {"case": f"M={m} C={c}", "max_abs_err": 0.0, "tol": 0, "bit_exact": True,
            "ms": time_ms(lambda: w8a8_quantize_scaled(x, w8a8_row_amax(x)), hold=True),
            "plain_ms": time_ms(plain, n=5, hold=True), "library_ms": None, "bound_ms": b_ms, "bound_by": by}


# (C, N, wo) of llama2-70b's projections on a rank of tensor 2 (serve-gang
# (d)'s) and of the example's tensor 8, w_gate first: wq, wk/wv, w_gate and
# w_up, w_down (whole groups: 28672 / t rows), wo (t's heads of 128), the
# lm_head (32000 / t).
Q4_70B = [(8192, 14336, False), (8192, 4096, False), (8192, 512, False), (14336, 8192, False), (4096, 8192, True),
          (8192, 16000, False),
          (8192, 3584, False), (8192, 1024, False), (8192, 128, False), (3584, 8192, False), (1024, 8192, True),
          (8192, 4000, False)]


def w8a8_matmul_case(gen, m, c, n):
    """The s8 x s8 -> s32 product with the two-scale epilogue
    (csrc/w8a8_matmul.cu) on int8 activations [m, c] from w8a8_quantize and
    a weight [c, n] quantized as the model's, against its plain version
    (float64 over the int8 values, exact): the raw s32 sums bit for bit,
    the bf16 output bit for bit and per output row within ROW_REL, a limit
    that must also reject the product without its last 128-row K tile (one
    stage of the kernel's ring). Timed with the L2 flushed before each
    launch, as a decode step streams the weights; the yardsticks are
    torch._int_mm (cuBLASLt, which refuses M <= 16: M padded to 32 rows)
    and torch.matmul over the dequantized bf16 weight (library_bf16_ms)."""
    import torch

    from substratus_tpu_torch.ops.quant import (quantize, w8a8_matmul, w8a8_matmul_plain, w8a8_quantize,
                                                w8a8_scale)

    dev = "cuda"
    qt = quantize(torch.randn((c, n), generator=gen, device=dev) * c**-0.5, (0,))
    wq, ws = qt.q, qt.scale.reshape(-1)
    x = torch.randn((m, c), generator=gen, device=dev).to(torch.bfloat16)
    xq, ascale = w8a8_quantize(x)
    a1 = ascale.reshape(-1)
    raw = torch.empty((m, n), dtype=torch.int32, device=dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    before = w8a8_matmul.launches
    w8a8_matmul(xq, a1, wq, ws, raw, raw=True)
    w8a8_matmul(xq, a1, wq, ws, out)
    y = w8a8_matmul_plain(xq, wq)
    ref = w8a8_scale(y, a1, ws, torch.bfloat16)
    torch.cuda.synchronize()
    label = f"w8a8_matmul m{m} c{c} n{n}"
    if w8a8_matmul.launches != before + 2:
        fail(f"{label}: launches not counted")
    if not torch.equal(raw, y):
        fail(f"{label}: {(raw != y).sum().item()} of {raw.numel()} s32 sums differ from the exact product")
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    if not (torch.isfinite(out.float()).all() and torch.equal(out, ref) and rel <= ROW_REL):
        fail(f"{label}: bf16 output max|err| {err}, row error {rel} (limit {ROW_REL})")
    k = c - 128
    short = w8a8_scale(w8a8_matmul_plain(xq[:, :k].contiguous(), wq[:k].contiguous()), a1, ws, torch.bfloat16)
    fault = row_rel_err(short, ref)
    if fault <= ROW_REL:
        fail(f"{label}: the limit {ROW_REL} accepts a dropped K tile (row error {fault})")
    l2 = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB, 5x the 50 MB L2

    def flush():
        l2.sum()

    pad = torch.zeros((max(m, 32), c), dtype=torch.int8, device=dev)
    pad[:m] = xq
    dense = qt.dequant(torch.bfloat16)
    b_ms, by = bound_int8(m * c + c * n + 4 * (m + n) + 2 * m * n, 2 * m * c * n)
    return {"case": f"M={m} C={c} N={n}", "max_abs_err": err, "tol": 0, "row_rel_err": rel,
            "fault_row_rel_err": fault, "bit_exact": True,
            "ms": time_ms(lambda: w8a8_matmul(xq, a1, wq, ws, out), flush=flush),
            "plain_ms": time_ms(lambda: w8a8_scale(w8a8_matmul_plain(xq, wq), a1, ws, torch.bfloat16), n=5,
                                flush=flush),
            "library_ms": yardstick_ms(lambda: torch._int_mm(pad, wq), flush=flush),
            "library_bf16_ms": time_ms(lambda: torch.matmul(x, dense), flush=flush),
            "bound_ms": b_ms, "bound_by": by}


def row_rel_err(got, ref) -> float:
    """The largest error of one output vector (a query row of dQ, a key's
    dK or dV, over D) relative to that vector's own norm, or to 2^-8 of
    the tensor's RMS vector norm where that is larger: a vector whose
    exact value is 0 (dQ of the first causal row, whose softmax holds one
    entry) comes out of either side as rounding residue."""
    import torch

    g, r = got.float(), ref.float()
    norms = r.norm(dim=-1)
    den = torch.maximum(norms, norms.square().mean().sqrt() * 2**-8).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - r).norm(dim=-1) / den).max().item()


def bwd_case(gen, b, s, h, kh, causal, d=128):
    """The flash backward's dQ and dK/dV kernels against their plain
    version on the same q, k, v, dO and the forward kernel's out and LSE,
    held per output vector (row_rel_err <= ROW_REL). A max-abs limit
    scaled by the largest value would let most keys' dK/dV go unchecked:
    key 0 is attended by every query and sets it, later keys are smaller.
    The limit must also reject two planted faults, built from the plain
    version: dQ without the last k-tile of the dQ kernel (64 keys; the 40
    live ones at S=1000) and dK/dV without the last q-tile of the dK/dV
    kernel (64 rows; the 40 live ones at S=1000). Each call must launch
    the design flash_bwd_design names. Returns one case for each kernel;
    their library call is one backward through
    scaled_dot_product_attention (all of dq, dk, dv), its forward outside
    the timed region."""
    import torch
    import torch.nn.functional as F

    from substratus_tpu_torch import kernels
    from substratus_tpu_torch.ops import flash_attention as fa
    from substratus_tpu_torch.ops.headdim import padded_head_dim

    dev = "cuda"
    q, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, s, kh, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    scale = d**-0.5
    out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
    delta = fa.bwd_delta(out, do)
    args = (q, k, v, do, lse, delta, causal, scale)
    dp = padded_head_dim(d)  # a head dim not built runs padded (q, k, v, dO) and is sliced back
    padded = [fn.launches_padded for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)]
    design = fa.flash_bwd_design(dp)
    counters = [getattr(fn, f"launches_{design}") for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)]
    got = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    ref = (fa._bwd_dq_plain(*args), *fa._bwd_dkv_plain(*args))
    launched = [getattr(fn, f"launches_{design}") - n
                for fn, n in zip((fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv), counters)]
    _, ds = fa._bwd_probs(*args)
    ds[..., 64 * ((s - 1) // 64):] = 0
    dq_fault = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(q.shape).to(q.dtype)
    del ds
    cut = 64 * ((s - 1) // 64)
    do_cut, delta_cut = do.clone(), delta.clone()
    do_cut[:, cut:], delta_cut[:, cut:] = 0, 0
    dkv_fault = fa._bwd_dkv_plain(q, k, v, do_cut, lse, delta_cut, causal, scale)
    torch.cuda.synchronize()
    label = f"flash backward b{b} s{s} h{h}/{kh} d{d} causal={causal}"
    padded = [fn.launches_padded - n for fn, n in zip((fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv), padded)]
    if launched != [1, 1] or padded != [int(dp != d)] * 2:
        fail(f"{label}: launches of the {design} design {launched}, at the padded route {padded}, want one of each "
             f"kernel{' padded' * (dp != d)}")
    errs, rels = [], []
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        errs.append((g.float() - r.float()).abs().max().item())
        rels.append(row_rel_err(g, r))
        if not (torch.isfinite(g.float()).all() and rels[-1] <= ROW_REL):
            fail(f"{label} {name}: row error {rels[-1]} (limit {ROW_REL}), max|err| {errs[-1]}")
    faults = (row_rel_err(dq_fault, ref[0]), max(row_rel_err(f, r) for f, r in zip(dkv_fault, ref[1:])))
    if min(faults) <= ROW_REL:
        fail(f"{label}: the limit {ROW_REL} accepts a planted fault (dq, dkv row errors {faults})")
    gqa = {"enable_gqa": True} if h != kh else {}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa)
    dot = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True))
    pairs = s * (s + 1) // 2 if causal else s * s
    read = 2 * (2 * b * s * h * d + 2 * b * s * kh * d) + 4 * 2 * b * h * s  # q, dO, k, v; lse, delta
    name = f"B={b} S={s} H={h} KH={kh} D={d}{f' (padded to {dp})' * (dp != d)} causal={causal}"
    dq_bound = bound(read + 2 * b * s * h * d, 6 * d * h * b * pairs)  # S, dP, dQ
    dkv_bound = bound(read + 2 * 2 * b * s * kh * d, 8 * d * h * b * pairs)  # S, dP, dV, dK
    delta_ms = time_ms(lambda: fa.bwd_delta(out, do))  # FlashAttention.backward's third launch
    # Host time of one call of the dQ kernel's C entry point: the wgmma
    # design encodes four tensor maps a call, the mma design none.
    # (at a built head dim: the padded route's pads are host and device work of their own)
    host_us = None
    if dp == d:
        dq_out = torch.empty_like(q)
        c_dq = getattr(kernels.library(), "flash_bwd_dq_wgmma" if design == "wgmma" else "flash_bwd_dq")
        c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq_out.data_ptr(), b, s, s, h, kh, d, kernels.DTYPE_CODES[q.dtype], scale, int(causal),
                  kernels.stream_ptr(q.device))
        host_us = host_time_us(lambda: kernels.check(c_dq(*c_args), "flash_bwd_dq"))
    return (
        {"case": name, "design": design, "max_abs_err": errs[0], "row_rel_err": rels[0],
         "fault_row_rel_err": faults[0], "delta_ms": delta_ms, "host_us": host_us,
         "ms": time_ms(lambda: fa.flash_attention_bwd_dq(*args)),
         "plain_ms": time_ms(lambda: fa._bwd_dq_plain(*args), n=5),
         "library_ms": library_ms, "bound_ms": dq_bound[0], "bound_by": dq_bound[1]},
        {"case": name, "design": design, "max_abs_err": max(errs[1:]), "row_rel_err": max(rels[1:]),
         "fault_row_rel_err": faults[1],
         "ms": time_ms(lambda: fa.flash_attention_bwd_dkv(*args)),
         "plain_ms": time_ms(lambda: fa._bwd_dkv_plain(*args), n=5),
         "library_ms": library_ms, "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1]},
    )


def kernel_phase():
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash = [
        flash_case(gen, 1, 512, 32, 32, True, compare=True),  # llama2-7b prefill, bucket 512
        flash_case(gen, 8, 1024, 32, 32, True, compare=True),  # one llama2-7b layer of a LoRA step (64 a step)
        flash_case(gen, 1, 100, 32, 32, True),  # a ragged length
        flash_case(gen, 1, 1000, 32, 32, True),  # ragged: the last q-tile holds 40 rows
        flash_case(gen, 1, 512, 32, 8, True),  # llama3-8b heads (GQA 4)
        flash_case(gen, 1, 384, 32, 32, False),
        flash_case(gen, 8, 1024, 32, 4, True, d=64),  # tinyllama's heads in training
        flash_case(gen, 1, 512, 71, 1, True, d=64),  # falcon-7b's heads (MQA, G = 71), a 512-token bucket
        flash_case(gen, 1, 512, 32, 32, True, d=80),  # opt-2.7b's heads: head_dim 80, padded to 128
    ]
    positions = [0, 1, 17, 255, 511, 700, 1000, 1023]
    decode = [
        decode_case(gen, 8, 1024, 32, 32, False, positions, compare=True),  # llama2-7b decode, B=8
        decode_case(gen, 8, 1024, 32, 32, True, positions, compare=True),
        decode_case(gen, 8, 1024, 32, 8, False, positions, compare=True),  # llama3-8b heads (GQA 4)
        decode_case(gen, 8, 1024, 32, 8, True, positions),
        decode_case(gen, 1, 4096, 32, 32, False, [4000], compare=True),  # one long conversation
        decode_case(gen, 8, 1024, 32, 4, False, positions, d=64, compare=True),  # tinyllama's heads (GQA 8)
        # serve-int4's cache length (two splits): at and around the first
        # split's end, before the cache and past it
        decode_case(gen, 8, 2048, 32, 32, False, [-1, 0, 1023, 1024, 1025, 1500, 2047, 3000]),
        # falcon-7b's heads (G = 71: nine slices of 8 rows) at its example's
        # max_batch 16, bf16 and int8; falcon-40b's (G = 16); a group of 3
        decode_case(gen, 16, 1024, 71, 1, False, positions * 2, d=64),
        decode_case(gen, 16, 1024, 71, 1, True, positions * 2, d=64),
        decode_case(gen, 8, 1024, 128, 8, False, positions, d=64),
        decode_case(gen, 8, 1024, 12, 4, False, positions),
        # opt-2.7b's heads (head_dim 80) over a cache laid out at 128, bf16
        # and int8; a group of 3 over an int8 cache of 1022 rows, which the
        # rows design does not take: the split design on 1024 rows
        decode_case(gen, 8, 1024, 32, 32, False, positions, d=80),
        decode_case(gen, 8, 1024, 32, 32, True, positions, d=80),
        decode_case(gen, 8, 1022, 12, 4, True, positions[:-1] + [1021]),
    ]
    cached = [
        cached_case(gen, 32, 32, False, compare=True),  # llama2-7b, the fifth chunk of a long prompt
        cached_case(gen, 32, 8, False),  # llama3-8b heads (GQA 4)
        cached_case(gen, 32, 32, False, limit_row=True),
        cached_case(gen, 32, 32, False, sq=100),  # a ragged chunk (the last q-tile holds 36 rows)
        cached_case(gen, 32, 4, False, d=64, sq=1000, start=1024),  # tinyllama's heads, ragged
        # a verify round of width 5 at B=8 over a 1024-row cache, two rows idle at S-1
        cached_case(gen, 32, 32, False, b=8, sq=5, sk=1024, starts=[0, 131, 302, 511, 777, 1019, 1023, 1023]),
        cached_case(gen, 32, 32, False, d=80),  # opt-2.7b's heads, the cache laid out at 128
    ]
    cached_int8 = [  # serve-int4's int8 cache
        cached_case(gen, 32, 32, True, compare=True),
        cached_case(gen, 32, 32, True, sq=100),
        cached_case(gen, 32, 4, True, d=64, sq=1000, start=1024),
        # serve-spec (b)'s verify of width 4 at B=24 over the int8 cache, two rows idle at S-1
        cached_case(gen, 32, 32, True, b=24, sq=4, sk=1024, starts=[37 * i for i in range(22)] + [1023, 1023]),
        cached_case(gen, 32, 32, True, d=80),  # head_dim 80 over an int8 cache laid out at 128
    ]
    spread = [0, 1, 300, 1024, 2047, 3000, 4000, 4095]  # one slot at S-1
    fused = [
        fused_case(gen, 32, 32, False, spread, compare=True),  # llama2-7b decode, B=8, S=4096
        fused_case(gen, 32, 32, True, spread, compare=True),  # serve-int4's int8 cache
        fused_case(gen, 32, 8, False, spread, compare=True),  # llama3-8b heads (GQA 4)
        fused_case(gen, 32, 8, True, spread, compare=True),
        fused_case(gen, 32, 32, False, [4000], b=1, compare=True),  # one long conversation
        fused_case(gen, 71, 1, False, [0, 1, 17, 255, 511, 700, 1000, 1023] * 2, b=16, s=1024, d=64),  # G = 71
        fused_case(gen, 32, 32, False, positions, s=1024, d=80),  # head_dim 80, the cache laid out at 128
        fused_case(gen, 12, 4, True, positions[:-1] + [1021], s=1022),  # a group of 3, int8, 1022 rows (1024)
    ]
    q4 = [  # the first case of each design is its main-path shape (q4_matmul.cu's: off the main path)
        q4_case(gen, 8, 11008, compare=True),  # llama2-7b w_gate/w_up at B=8
        q4_case(gen, 8, 4096, c=11008, compare=True),  # w_down at B=8
        q4_case(gen, 8, 32000, compare=True),  # the lm_head at B=8
        q4_case(gen, 8, 4096, compare=True),  # wq/wk/wv/wo at B=8
        q4_case(gen, 1, 11008, compare=True),  # one decoding slot
        q4_case(gen, 16, 11008, compare=True),  # the 16-token prefill bucket
        q4_case(gen, 8, 128256, compare=True),  # llama3-8b's lm_head at B=8
        q4_case(gen, 8, 14336, compare=True),  # a mixtral-8x7b expert's w_gate/w_up at B=8 (serve-moe)
        q4_case(gen, 8, 4096, c=14336, compare=True),  # an expert's w_down at B=8
        q4_case(gen, 512, 11008),  # w_gate over a 512-token prefill bucket or chunk
        q4_case(gen, 128, 32000),  # the lm_head over a 128-token prefill bucket
        q4_case(gen, 512, 4096),  # wq/wk/wv/wo over a 512-row chunk
        q4_case(gen, 512, 4096, c=11008),  # w_down over a 512-row chunk
        q4_case(gen, 512, 32000),  # the lm_head over a 512-row chunk
        q4_case(gen, 512, 14336),  # an expert's w_gate over a 512-row chunk (serve-moe)
        q4_case(gen, 32, 11008),  # w_gate over a 32-token bucket
        q4_case(gen, 24, 11008),  # w_gate of a width-1 round at B=24 (serve-spec)
        q4_case(gen, 96, 11008),  # w_gate of a width-4 verify at B=24
        q4_case(gen, 200, 4096),  # a ragged row count (the planted dropped row tile)
        q4_case(gen, 8, 2048, c=2048, heads=32),  # tinyllama's wo at B=8: groups of 64
        q4_case(gen, 8, 1000),  # N not a multiple of 16
        q4_case(gen, 77, 2048, c=2048, heads=32),  # a ragged row count, groups of 64
    ]
    bwd = [
        bwd_case(gen, 8, 1024, 32, 32, True),  # one llama2-7b layer at the finetune example's batch
        bwd_case(gen, 8, 1024, 32, 8, True),  # GQA 4
        bwd_case(gen, 2, 1000, 32, 32, True),  # ragged: the last tile holds 40 rows
        bwd_case(gen, 2, 384, 32, 32, False),
        bwd_case(gen, 8, 1024, 32, 4, True, d=64),  # tinyllama's heads
        bwd_case(gen, 2, 1024, 32, 32, True, d=32),  # the mma design (head_dim 16 and 32)
        bwd_case(gen, 2, 1024, 71, 1, True, d=64),  # falcon-7b's LoRA step: dK/dV summed over 71 heads
        bwd_case(gen, 2, 512, 32, 32, True, d=80),  # opt-2.7b's LoRA step (B=2 S=512), padded to 128
    ]
    # The instances at head_dim 256 (gemma's; 129-255 run padded to them):
    # the mma.sync designs of the forward, the cached flash and the
    # backward (dK/dV in two column halves), the rows design of the decode
    # kernels, the split design's 4-warp instance for a group the rows
    # design does not take; the first case of each is the shape
    # serve-adapters (c) runs (gemma-7b's 16 heads of 256 on 16 kv heads).
    d256 = {
        "flash_fwd_d256": [flash_case(gen, 1, 512, 16, 16, True, d=256),
                           flash_case(gen, 1, 1000, 16, 16, True, d=256),  # ragged
                           flash_case(gen, 1, 512, 32, 32, True, d=192)],  # padded to 256
        "flash_cached_d256": [cached_case(gen, 16, 16, False, d=256, sk=2048, start=512),
                              cached_case(gen, 16, 16, False, d=192, sk=2048, start=512)],
        "flash_cached_int8_d256": [cached_case(gen, 16, 16, True, d=256, sk=2048, start=512),
                                   cached_case(gen, 16, 16, True, d=256, sq=100, sk=2048, start=700)],
        "decode_attn_d256": [decode_case(gen, 8, 1024, 16, 16, False, positions, d=256),
                             decode_case(gen, 8, 1024, 16, 16, True, positions, d=256),
                             decode_case(gen, 8, 1024, 8, 1, False, positions, d=256),  # gemma-2b's heads (G = 8)
                             decode_case(gen, 8, 1024, 16, 16, False, positions, d=192)],
        "fused_decode_d256": [fused_case(gen, 16, 16, True, positions, s=1024, d=256),
                              fused_case(gen, 16, 16, False, positions, s=1024, d=256),
                              fused_case(gen, 8, 1, True, positions, s=1024, d=256)],
        # a group of 3 at 256: the split design on 4 warps, bf16 and int8 (1022 rows laid out at 1024)
        "decode_split_d256": [decode_case(gen, 8, 1024, 12, 4, False, positions, d=256),
                              decode_case(gen, 8, 1022, 12, 4, True, positions[:-1] + [1021], d=256),
                              fused_case(gen, 12, 4, True, positions[:-1] + [1021], s=1022, d=256)],
    }
    bwd256 = [bwd_case(gen, 2, 1024, 16, 16, True, d=256),  # a LoRA step at gemma-7b's heads
              bwd_case(gen, 2, 1000, 16, 8, True, d=256),  # ragged, GQA 2
              bwd_case(gen, 2, 512, 32, 32, True, d=192)]  # padded to 256
    # w8a8: the first case of each is the main path's (serve-w8a8's decode
    # step at B=8: the quantize of a layer's input, w_gate's product)
    w8a8_quant = [w8a8_quantize_case(gen, m, c) for m in (8, 1, 512) for c in (4096, 11008, 14336)]
    w8a8_mm = [w8a8_matmul_case(gen, m, c, n) for m in (8, 1, 512)
               for c, n in ((4096, 11008), (4096, 4096), (11008, 4096), (4096, 32000), (4096, 14336))]
    # serve-gang's per-rank shapes (tensor=2: llama2-7b's 32 heads and 32 kv
    # heads halved), the first case of each the gang's main path: a 512-token
    # bucket, the decode step at B=8 over its 2048-row cache (and over 1024
    # rows, the decode cases' length above), the 1500-token prompt's third
    # chunk.
    # serve-gang (d)'s int4 shapes a rank (llama2-70b at tensor 2, then the
    # example's tensor 8) at a decode step's 16 rows (max_batch 32 over data
    # 2) and a 512-row chunk, each the design q4_design names; (e)'s
    # row-parallel quantization of w_down's input (llama2-7b at tensor 2:
    # 5504 of 11008 a rank, 8 rows) first, then llama2-70b's at both.
    q4_70b = [q4_case(gen, m, n, c=c, heads=c // 128 if wo else None) for m in (16, 512) for c, n, wo in Q4_70B]
    w8a8_rows = [w8a8_rows_case(gen, m, c) for m, c in ((8, 5504), (16, 14336), (16, 3584), (512, 14336))]
    tp2 = {"flash_fwd_tp2": [flash_case(gen, 1, 512, 16, 16, True)],
           "decode_attn_tp2": [decode_case(gen, 8, 2048, 16, 16, False, positions[:-1] + [2047]),
                               decode_case(gen, 8, 1024, 16, 16, False, positions)],
           "flash_cached_tp2": [cached_case(gen, 16, 16, False, sk=2048, start=1024)],
           # serve-gang (f)'s verify rounds at a rank's heads: the dense leg's
           # width-4 verify at B=24 over the int8 cache, two rows idle at S-1;
           # the int4 wgmma design at that verify's 96 rows over a rank's w_gate
           "flash_cached_int8_verify_tp2": [cached_case(gen, 16, 16, True, b=24, sq=4, sk=1024,
                                                        starts=[37 * i for i in range(22)] + [1023, 1023])],
           "q4_matmul_wgmma_verify_tp2": [q4_case(gen, 96, 5504)]}
    if tp2["q4_matmul_wgmma_verify_tp2"][0]["design"] != "wgmma":
        fail(f"kernels: M=96 N=5504 took the {tp2['q4_matmul_wgmma_verify_tp2'][0]['design']} design, not wgmma")
    report = {"flash_fwd": flash, "decode_attn": decode, "flash_cached": cached, "flash_cached_int8": cached_int8,
              "fused_decode": fused,
              "q4_matmul_decode": [c for c in q4 if c["design"] == "decode"],
              "q4_matmul": [c for c in q4 if c["design"] == "mma"],
              "q4_matmul_wgmma": [c for c in q4 if c["design"] == "wgmma"],
              "flash_bwd_dq": [c[0] for c in bwd], "flash_bwd_dkv": [c[1] for c in bwd],
              **d256, "flash_bwd_dq_d256": [c[0] for c in bwd256], "flash_bwd_dkv_d256": [c[1] for c in bwd256],
              "w8a8_quantize": w8a8_quant, "w8a8_matmul": w8a8_mm, **tp2,
              "q4_matmul_decode_70b": [c for c in q4_70b if c["design"] == "decode"],
              "q4_matmul_wgmma_70b": [c for c in q4_70b if c["design"] == "wgmma"],
              "w8a8_quantize_rows": w8a8_rows}
    if len(report["q4_matmul_decode_70b"]) != len(Q4_70B) or len(report["q4_matmul_wgmma_70b"]) != len(Q4_70B):
        fail(f"kernels: llama2-70b's per-rank int4 shapes took other designs than decode at 16 rows and wgmma at "
             f"512: {[(c['case'], c['design']) for c in q4_70b]}")
    for name, cases in report.items():
        for c in cases:
            lib = "n/a" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
            if "row_rel_err" in c:
                planted = "" if c["fault_row_rel_err"] is None else f"; planted fault {c['fault_row_rel_err']:.4g}"
                check = f"row error {c['row_rel_err']:.4g} (limit {ROW_REL}{planted}), max|err| {c['max_abs_err']:.3g}"
            else:
                check = f"max|err| {c['max_abs_err']:.3g} (tol {c['tol']})"
            design = f" ({c['design']} design{', plan ' + str(c['plan']) if 'plan' in c else ''})" if "design" in c else ""
            print(f"kernel {name} [{c['case']}]{design}: {check}"
                  f"{' lse ' + format(c['lse_max_abs_err'], '.3g') if 'lse_max_abs_err' in c else ''}"
                  f" | ms {c['ms']:.4f} plain {c['plain_ms']:.4f} library {lib}"
                  f"{' (on head-major copies ' + format(c['library_contiguous_ms'], '.4f') + ')' if 'library_contiguous_ms' in c else ''}"
                  f"{' unfused ' + format(c['unfused_ms'], '.4f') if 'unfused_ms' in c else ''}"
                  f" bound {c['bound_ms']:.4f} ({c['bound_by']})", flush=True)
    for name in ("flash_fwd", "flash_cached", "flash_cached_int8", "decode_attn", "fused_decode"):
        for c in report[name]:
            if "turns_ms" in c:
                print(f"{name} [{c['case']}] in turns, ms: "
                      + "; ".join(f"{x} {', '.join(f'{t:.4f}' for t in ts)}" for x, ts in c["turns_ms"].items())
                      + f" (SDPA {'n/a' if c['library_ms'] is None else format(c['library_ms'], '.4f')}"
                      f"{', on head-major copies ' + format(c['library_contiguous_ms'], '.4f') if 'library_contiguous_ms' in c else ''}"
                      f", bound {c['bound_ms']:.4f}); host time a call of each C "
                      "entry point: " + ", ".join(f"{x} {us:.1f} us" for x, us in c["host_us"].items()), flush=True)
    for c in report["w8a8_matmul"]:
        int_mm = "refused" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        print(f"w8a8_matmul [{c['case']}] (L2 flushed): ms {c['ms']:.4f}, torch._int_mm {int_mm} (M "
              f"padded to 32 where smaller), torch.matmul on the dequantized bf16 weight {c['library_bf16_ms']:.4f}, "
              f"bound {c['bound_ms']:.4f} ({c['bound_by']}); s32 sums and bf16 output bit for bit the plain "
              f"version's, a dropped K tile {c['fault_row_rel_err']:.4g}", flush=True)
    for c in report["q4_matmul_decode"]:
        print(f"q4_matmul_decode [{c['case']}] plan {c['plan']} in turns with q4_matmul.cu, ms (L2 flushed): "
              + "; ".join(f"{x} {', '.join(f'{t:.4f}' for t in ts)}" for x, ts in c["turns_ms"].items())
              + f" (torch.matmul on the bf16 weight {c['library_ms']:.4f}, bound {c['bound_ms']:.4f})", flush=True)
    for dq, dkv in zip(report["flash_bwd_dq"] + report["flash_bwd_dq_d256"],
                       report["flash_bwd_dkv"] + report["flash_bwd_dkv_d256"]):
        host = f"{dq['host_us']:.1f} us" if dq["host_us"] is not None else "n/a (padded)"
        print(f"flash backward [{dq['case']}]: dq {dq['ms']:.4f} + dkv {dkv['ms']:.4f} + bwd_delta "
              f"{dq['delta_ms']:.4f} = {dq['ms'] + dkv['ms'] + dq['delta_ms']:.4f} ms against SDPA's backward "
              f"{dq['library_ms']:.4f}; dq's C entry point {host} of host time a call "
              f"({dq['design']} design)", flush=True)
    return report


# --- the main path: serve.main's server ---------------------------------------

PROMPTS = [  # (text, max_tokens, temperature, stream): ByteTokenizer ids = 1 + bytes
    ("The quick brown", 32, 0.0, False),  # 16 tokens -> bucket 16
    ("x" * 99, 32, 0.0, True),  # 100 tokens -> bucket 128, streamed
    ("serve " * 66 + "abc", 32, 0.0, False),  # 400 tokens -> bucket 512
    ("A sampled reply " * 6 + "!!!", 32, 0.8, False),  # 100 tokens, temperature 0.8
    ("Greedy again, sixteen..", 32, 0.0, False),
]


# Every server this script talks to is its own child on 127.0.0.1: no
# proxy from the environment.
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http(base: str, path: str, body=None, headers=None, timeout: float = 600, on_first=None):
    """(status, headers, text) of a GET (body None) or a JSON POST;
    `on_first` runs once the body's first line is in (a stream's first
    chunk). A read past `timeout` raises TimeoutError naming the request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"{base}{path}", data=data, headers={"Content-Type": "application/json",
                                                                       **(headers or {})})
    try:
        with LOCAL.open(req, timeout=timeout) as r:
            first = r.readline()
            if on_first is not None:
                on_first()
            return r.status, dict(r.headers), (first + r.read()).decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()
    except TimeoutError:
        raise TimeoutError(f"{'GET' if body is None else 'POST'} {base}{path}: no answer within {timeout} s") from None


def wait_ok(base: str, label: str, deadline_s: float = 120) -> None:
    """GET / until it answers 200, within `deadline_s`; a read that times
    out on the way counts as not ready yet."""
    deadline = time.perf_counter() + deadline_s
    while True:
        try:
            if http(base, "/", timeout=30)[0] == 200:
                return
        except TimeoutError:
            pass
        if time.perf_counter() > deadline:
            fail(f"{label}: the server printed its address but GET / is not 200 after {deadline_s} s")
        time.sleep(0.1)


def sse_parse(text: str, chat: bool = False):
    """(pieces, finish, usage, done) of an SSE body: a piece a choice."""
    pieces, finish, usage, done = [], None, None, False
    for line in text.split("\n"):
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            done = True
            continue
        obj = json.loads(line[6:])
        usage = obj.get("usage") or usage
        for ch in obj["choices"]:
            pieces.append(ch["delta"].get("content", "") if chat else ch["text"])
            finish = ch["finish_reason"] or finish
    return pieces, finish, usage, done


def post(base: str, body: dict):
    """(status, the JSON body or a stream's {usage, finish, chunks}, the
    client's time to the first chunk) of a completion."""
    t0, ttft = time.perf_counter(), []
    status, _, text = http(base, "/v1/completions", body, on_first=lambda: ttft.append(time.perf_counter() - t0))
    if status != 200:
        return status, text, None
    if not body.get("stream"):
        return status, json.loads(text), None
    pieces, finish, usage, _ = sse_parse(text)
    return status, {"usage": usage, "finish": finish, "chunks": len(pieces)}, ttft[0]


def wait_idle(engine) -> None:
    """Let the scheduler finish the iteration that released the last slot
    (its step counters land just after the final token is delivered)."""
    deadline = time.time() + 30
    while engine.active.any() and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.5)


def reference_check(engine) -> dict:
    """Hold the engine's greedy tokens (decode kernel over the slot cache)
    against one teacher-forced forward of prompt + tokens through the
    flash kernel, and that forward against the plain attention path."""
    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    prompt = ByteTokenizer().encode(PROMPTS[0][0])
    toks = engine.generate(prompt, max_tokens=16, temperature=0.0)
    seq = torch.tensor([prompt + toks[:-1]], device=engine.device)
    cfg = engine.cfg
    with torch.inference_mode():
        kern, _ = llama.forward(engine.params, seq, cfg)
        plain, _ = llama.forward(engine.params, seq, cfg.replace(attn_impl="plain"))
    kern, plain = kern[0, len(prompt) - 1:], plain[0, len(prompt) - 1:]
    scale = kern.abs().max().item()
    path_err = (kern - plain).abs().max().item()
    # How far below the reference's best logit each served token lies.
    gaps = (kern.max(dim=-1).values - kern[torch.arange(len(toks)), torch.tensor(toks)]).tolist()
    agree = sum(int(kern[i].argmax()) == t for i, t in enumerate(toks))
    out = {"tokens": toks, "logit_scale": scale, "kernel_vs_plain_max_abs": path_err,
           "argmax_agree": agree, "max_gap": max(gaps)}
    print(f"reference: {agree}/{len(toks)} served greedy tokens are the argmax of the teacher-forced "
          f"forward (largest gap {max(gaps):.4g}); kernel vs plain logits max|diff| {path_err:.4g} "
          f"at logit scale {scale:.4g}", flush=True)
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        fail("non-finite logits")
    if not toks or path_err > 0.05 * scale or max(gaps) > 0.05 * scale:
        fail(f"served tokens or logits disagree with the reference: {out}")
    return out


# Kernel-name fragments of the int4 matmul (its three designs' kernels and
# q4_matmul.cu's split-K sums) and of cuBLAS's GEMMs.
Q4_NAMES = ("q4_matmul_decode", "q4_matmul", "q4_splitk")
GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass")
# The flash kernels, each timed on its own in a profile: the forward's two
# designs, the cached flash's mma design (the wgmma design's cached kernel
# is flash_fwd_wgmma_kernel<D, true>), the backward's.
FLASH_NAMES = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel", "flash_cached_kernel", "flash_bwd_dq", "flash_bwd_dkv")
# The decode kernels: the split design (csrc/decode_split.cu; decode and
# fused alike, told apart by the phase's decode_attn_impl) and its combine,
# the rows design's two.
DECODE_NAMES = ("decode_split_kernel", "decode_combine_kernel", "decode_attn_kernel", "fused_decode_kernel")


def _device_summary(prof, wall: float, reps: int, top_n: int = 10) -> dict:
    """Device busy time, the top kernels, and the time of the int4 matmul,
    of the GEMMs and of each flash kernel, of a profile (device-side events
    only: the CPU ops that launched them carry the same time)."""
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def ms_of(names):
        return sum(dev_us(e) for e in kernels if any(s in e.key.lower() for s in names)) / 1e3 / reps

    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:top_n]
    return {"profiled_ms": 1e3 * wall / reps, "device_busy_ms": 1e3 * busy / reps,
            "q4_matmul_ms": ms_of(Q4_NAMES), "q4_matmul_wgmma_ms": ms_of(("q4_matmul_wgmma",)),
            "q4_matmul_decode_ms": ms_of(("q4_matmul_decode",)), "q4_splitk_ms": ms_of(("q4_splitk",)),
            "gemm_ms": ms_of(GEMM_NAMES), "copy_ms": ms_of(("copy",)), "gather_ms": ms_of(("gather",)),
            "flash_ms": {name: ms_of((name.lower(),)) for name in FLASH_NAMES},
            "decode_ms": {name: ms_of((name,)) for name in DECODE_NAMES},
            "top": [{"name": e.key, "ms": dev_us(e) / 1e3 / reps, "calls": e.count / reps} for e in top]}


def profile_engine(engine, label: str = "profile", lens=(16, 400), fill: int = 100, steps: int = 8,
                   alt_decode=None) -> dict:
    """Host-clock prefill times of prompts of `lens` tokens and the
    decode-step time, and, under torch.profiler, the device busy time and
    top kernels of the longer prefill and of decode steps with every slot
    active (the rest filled with `fill`-token prompts). The decode steps
    are the engine's own: overlapped, each a replay of its captured graph,
    `steps` of them and the flush of the last. With alt_decode, the same
    slots also decode with that decode_attn_impl, in turns with the
    configured one: a new model config makes the engine capture a new
    graph, so each turn replays its own impl's graph (captured before the
    turn is timed). Driven from this thread after the scheduler has
    stopped."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from substratus_tpu_torch.serve.engine import Request

    def admit(n: int) -> float:  # one prompt of n tokens into a free slot
        engine.queue.put(Request([256] + [65] * (n - 1), max_tokens=10_000, temperature=0.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if engine._admit() != 1:
            fail("profile: admission failed")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def decode(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine._step()
        engine._flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    short, long = lens
    out = {"prefill_ms": {n: 1e3 * min(admit(n), admit(n)) for n in lens}}
    chunks = engine.stats["prefill_chunks"]
    with profile(activities=activities) as prof:
        wall = admit(long)
    out[f"prefill_{long}"] = _device_summary(prof, wall, 1)
    out["chunks"] = int(engine.stats["prefill_chunks"] - chunks)
    while not engine.active.all():
        admit(fill)
    decode(2)
    out["decode_step_ms"] = 1e3 * decode(steps) / steps
    with profile(activities=activities) as prof:
        wall = decode(steps)
    out["decode"] = _device_summary(prof, wall, steps)
    out["batch"] = int(engine.active.sum())
    # Kernels launched inside a replayed graph reach the profile only if
    # CUPTI reports them: the step's attention kernel must be named.
    out["graph_kernels_named"] = any(out["decode"]["decode_ms"].values())
    if alt_decode is not None:
        cfg = engine.cfg
        cfgs = {cfg.decode_attn_impl: cfg, alt_decode: cfg.replace(decode_attn_impl=alt_decode)}
        turns = {cfg.decode_attn_impl: [out["decode_step_ms"]], alt_decode: []}
        for impl in (alt_decode, alt_decode, cfg.decode_attn_impl):
            engine.cfg = cfgs[impl]
            decode(1)  # captures this impl's graph when the config changed
            turns[impl].append(1e3 * decode(steps) / steps)
        engine.cfg = cfgs[alt_decode]
        decode(1)
        with profile(activities=activities) as prof:
            wall = decode(steps)
        engine.cfg = cfg
        out["decode_turns_ms"] = turns
        out[f"decode_{alt_decode}"] = _device_summary(prof, wall, steps)
        print(f"{label}: decode step at B={out['batch']} in turns, ms: "
              + "; ".join(f"{impl} {', '.join(f'{t:.2f}' for t in ts)}" for impl, ts in turns.items())
              + f" (each impl's own captured graph); device busy {out['decode']['device_busy_ms']:.2f} ms "
              f"({cfg.decode_attn_impl}) against {out[f'decode_{alt_decode}']['device_busy_ms']:.2f} ms ({alt_decode})",
              flush=True)
    pre = out[f"prefill_{long}"]
    busy = out["decode"]["device_busy_ms"] or float("nan")  # nan: the profile saw no device time
    print(f"{label}: prefill {short} tokens {out['prefill_ms'][short]:.1f} ms, {long} tokens "
          f"{out['prefill_ms'][long]:.1f} ms in {out['chunks'] or 1} chunk(s) (device busy "
          f"{pre['device_busy_ms']:.2f} ms; int4 matmul {pre['q4_matmul_ms']:.2f} ms, wgmma design "
          f"{pre['q4_matmul_wgmma_ms']:.2f} ms of it); decode step at B={out['batch']} "
          f"{out['decode_step_ms']:.2f} ms, overlapped graph replays (device busy "
          f"{busy:.2f} ms, {100 * busy / out['decode_step_ms']:.1f}%, the step {out['decode_step_ms'] / busy:.2f}x "
          f"it; int4 matmul "
          f"{out['decode']['q4_matmul_ms']:.3f} ms (decode design {out['decode']['q4_matmul_decode_ms']:.3f}, "
          f"q4_matmul.cu's split-K sums {out['decode']['q4_splitk_ms']:.3f}), GEMMs "
          f"{out['decode']['gemm_ms']:.3f} ms of it)", flush=True)
    decode_kernels = {name: round(ms, 4) for name, ms in out["decode"]["decode_ms"].items() if ms}
    if not out["graph_kernels_named"] and not engine.paged:  # the paged step runs no decode kernel
        print(f"{label}: the profile names no decode kernel inside the replayed graph", flush=True)
    print(f"{label}: decode step, decode kernels, ms a step: {decode_kernels}"
          + (f"; {alt_decode}: " + str({name: round(ms, 4) for name, ms in out[f'decode_{alt_decode}']['decode_ms'].items()
                                        if ms}) if alt_decode is not None else ""), flush=True)
    flash = {name: ms for name, ms in pre["flash_ms"].items() if ms}
    print(f"{label}: prefill {long} tokens, flash kernels, ms: {flash}", flush=True)
    for phase in (f"prefill_{long}", "decode"):
        for e in out[phase]["top"]:
            print(f"{label} {phase}: {e['ms']:8.3f} ms {e['calls']:6.1f} calls  {e['name'][:80]}", flush=True)
    return out


# (dim, layers, heads, kv heads, vocabulary) of the full-width models served.
LLAMA2_7B = ("llama2-7b", (4096, 32, 32, 32, 32000))


def at_depth(name: str, layers: int) -> str:
    """The named config `name` at `layers` of its layers, registered in its
    family's CONFIGS in this process as f"{name}@{layers}" (serve.main and
    train.main, run in-process, draw it by that name); that name."""
    from substratus_tpu_torch.models import registry

    family, cfg = registry.find_named_config(name)
    cut = f"{name}@{layers}"
    family.CONFIGS[cut] = cfg.replace(n_layers=layers)
    return cut


def llama2_7b_at(layers: int) -> tuple:
    """start_server's `model` for llama2-7b's width at `layers` layers."""
    return (f"llama2-7b at {layers} layers", (4096, layers, 32, 32, 32000))


# serve-families (a)'s and (c)'s depth: falcon-7b's width at 4 of its 32
# layers, cut so that the default run stays within its time limit (16 once
# serve-gang joined it, 8 to keep it well inside, 4 once serve-gang's
# llama2-70b leg did; every check as at full depth).
FALCON_LAYERS = 4
FALCON_7B = (f"falcon-7b at {FALCON_LAYERS} layers", (4544, FALCON_LAYERS, 71, 1, 65024))
OPT_125M = ("opt-125m", (768, 12, 12, 12, 50272))


def start_server(name: str, params: dict, argv=(), model=LLAMA2_7B):
    """serve.main's server in-process from a params.json (and `argv`), at
    the full width and depth of `model` (llama2-7b unless named), answering
    GET / and warmed up by one request. Returns (server, engine, base
    URL)."""
    import torch

    from substratus_tpu_torch.serve import main as serve_main

    OUT_DIR.mkdir(exist_ok=True)
    params_path = OUT_DIR / f"chip_smoke_params_{name}.json"
    params_path.write_text(json.dumps(params))
    t0 = time.perf_counter()
    server = serve_main.build(["--params", str(params_path), "--host", "127.0.0.1", "--port", "0", *argv])
    engine = server.state.engine
    torch.cuda.synchronize()
    cfg = engine.cfg
    if (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size) != model[1]:
        fail(f"not {model[0]} at full width and depth: {cfg}")
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    print(f"{name}: {model[0]} built in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card)", flush=True)
    if (status := http(base, "/", timeout=60)[0]) != 200:
        fail(f"GET / -> {status}")
    post(base, {"prompt": "warm up", "max_tokens": 2, "temperature": 0.0})  # cuBLAS handles etc.
    wait_idle(engine)
    return server, engine, base


def run_concurrent(base: str, prompts) -> tuple:
    """POST every (text, max_tokens, temperature, stream) at once; returns
    ([(status, body, ttft)], wall seconds)."""
    results = [None] * len(prompts)

    def run(i, text, max_tokens, temp, stream):
        body = {"prompt": text, "max_tokens": max_tokens, "temperature": temp}
        if stream:
            body.update(stream=True, stream_options={"include_usage": True})
        try:
            results[i] = post(base, body)
        except Exception as e:  # reported by check_usage as a failed request
            results[i] = (None, repr(e), None)

    t_run = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i, *p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t_run


def check_usage(prompts, results, encode=None) -> int:
    """Every status 200 with the right usage (prompt tokens: `encode`'s
    count, else ByteTokenizer's) and finish; returns the number of
    generated tokens."""
    generated = 0
    for (text, max_tokens, temp, stream), (status, body, _) in zip(prompts, results):
        if status != 200:
            fail(f"request {text[:20]!r}: {status} {body}")
        usage = body["usage"]
        n_prompt = len(encode(text)) if encode else len(text.encode()) + 1
        if usage is None or usage["prompt_tokens"] != n_prompt or not 1 <= usage["completion_tokens"] <= max_tokens:
            fail(f"request {text[:20]!r}: usage {usage}, want {n_prompt} prompt tokens")
        finish = body["finish"] if stream else body["choices"][0]["finish_reason"]
        if (finish == "length") != (usage["completion_tokens"] == max_tokens):
            fail(f"request {text[:20]!r}: finish {finish} with {usage['completion_tokens']} tokens")
        if stream and body["chunks"] != usage["completion_tokens"] + 1:
            fail(f"streamed request: {body['chunks']} chunks for {usage['completion_tokens']} tokens")
        generated += usage["completion_tokens"]
    return generated


def zero_counts(engine, counters) -> None:
    for k, v in engine.stats.items():
        engine.stats[k] = 0 * v
    for c in counters:
        for name in vars(c):
            if name.startswith("launches"):  # q4_matmul also counts per design
                setattr(c, name, 0)


def launched(engine, fn, attr: str = "launches") -> int:
    """A kernel counter's launches since zero_counts: the wrapper's own
    count (the eager launches) plus those that the replays of the engine's
    captured decode step hold, which no wrapper sees."""
    return getattr(fn, attr) + engine.replayed_launches(f"{fn.__name__}.{attr}")


def sync_free(fn, *args):
    """fn(*args) with every host sync an error (set_sync_debug_mode)."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def check_graph_run(engine, stats: dict, label: str) -> None:
    """The phase's decode steps all replayed the one graph the engine
    captured (at the warm-up request, before the counts were zeroed)."""
    if not engine.decode_graph or not engine.overlap or engine._graph is None or engine._graph.graph is None:
        fail(f"{label}: the default engine must be overlapped with a captured decode step")
    if stats["graph_replays"] != stats["decode_steps"] or stats["graph_warmups"] != 0 or not stats["decode_steps"]:
        fail(f"{label}: {stats['decode_steps']} decode steps, {stats['graph_replays']} replays, "
             f"{stats['graph_warmups']} warm-ups: every step must replay the graph captured before")
    print(f"{label}: every decode step a replay of the graph captured at the warm-up request (warm-up and capture "
          f"{engine._graph.capture_seconds * 1e3:.1f} ms); one replay holds {engine._graph.captured}", flush=True)


def eager_check(engine, requests, label: str, params=None) -> dict:
    """The phase's requests served again, all submitted at once, through a
    second engine with the served engine's knobs: by default on the same
    weights with overlap=False and the eager step (decode_graph=False);
    given `params` (the weights a checkpoint was written from), the default
    engine (overlapped, the step a graph) on those. Every greedy request's
    tokens and finish must be the served run's. Returns that run's step
    numbers."""
    import dataclasses

    import torch

    from substratus_tpu_torch.serve.engine import Engine, Request

    if params is None:
        ec = dataclasses.replace(engine.ec, overlap=False)
        eager = Engine(engine.cfg, engine.params, ec, device=engine.device, model=engine.model, decode_graph=False,
                       adapters=engine.adapters)
        if eager.overlap or eager.decode_graph:
            fail(f"{label}: the comparison engine must be synchronous and eager")
    else:
        eager = Engine(engine.cfg, params, engine.ec, device=engine.device, model=engine.model,
                       adapters=engine.adapters)
    eager.start()
    try:
        reqs = [eager.submit(Request(list(r.prompt_tokens), max_tokens=r.max_tokens, temperature=r.temperature,
                                     top_p=r.top_p, adapter=r.adapter)) for r in requests]
        outs = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=600)) is not None:
                toks.append(tok)
            outs.append((toks, req.finish_reason))
    finally:
        eager.stop()
    greedy = 0
    for req, (toks, finish) in zip(requests, outs):
        if req.temperature == 0.0:
            greedy += 1
            if (toks, finish) != (req.out.tokens, req.finish_reason):
                fail(f"{label}: a greedy request's tokens differ between the served engine and the comparison "
                     f"one: {req.out.tokens} ({req.finish_reason}) against {toks} ({finish})")
    st = eager.stats
    out = {"greedy_identical": greedy, "decode_steps": st["decode_steps"], "graph_replays": st["graph_replays"],
           "step_ms": 1e3 * st["decode_seconds"] / st["decode_steps"],
           "decode_tokens_per_s": sum(len(t) - 1 for t, _ in outs) / st["decode_seconds"]}
    how = "overlap=false and the eager step" if params is None else "an in-process engine on the source weights"
    print(f"{label}: the same {len(requests)} requests through {how}: all {greedy} greedy "
          f"requests token for token the served run's; mean step {out['step_ms']:.2f} ms over "
          f"{st['decode_steps']} steps, decode {out['decode_tokens_per_s']:.1f} tokens/s", flush=True)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return out


def graph_checks(engine, requests, label: str) -> dict:
    """On the stopped engine of a serve phase: each sampled token lies
    inside its request's top-k / top-p mask of a teacher-forced forward;
    four replays of the captured step at temperature 50 on the same inputs
    draw four different rows and advance the generator; then every slot
    filled (greedy and sampled) and 16 steady-state overlapped steps whose
    dispatch half runs under set_sync_debug_mode("error"), with their host
    clock a step."""
    import numpy as np
    import torch

    from substratus_tpu_torch.ops.sampling import masked_logits
    from substratus_tpu_torch.serve.engine import Request

    sampled = [r for r in requests if r.temperature > 0]
    for req in sampled:
        prompt, toks = engine.clipped_prompt(req.prompt_tokens), req.out.tokens
        with torch.inference_mode():
            logits, _ = engine.model.forward(engine.params, torch.tensor([prompt + toks[:-1]], device=engine.device),
                                      engine.cfg)
        n = len(toks)
        masked = masked_logits(logits[0, len(prompt) - 1:], torch.full((n,), req.temperature, device=engine.device),
                               engine.ec.top_k, torch.full((n,), req.top_p, device=engine.device))
        if not n or not torch.isfinite(masked[torch.arange(n), torch.tensor(toks)]).all():
            fail(f"{label}: a sampled token lies outside its mask: {toks}")
    graph, b = engine._graph, engine.ec.max_batch
    offset = engine.generator.get_offset()
    hot = (engine.tokens, engine.positions, np.full(b, 50.0, np.float32), np.ones(b, np.float32), np.ones(b, bool),
           *((engine.block_table,) if engine.paged else ()))
    draws = [tuple(graph.launch(*hot)().tolist()) for _ in range(4)]
    advanced = engine.generator.get_offset() - offset
    if len(set(draws)) != len(draws) or advanced <= 0 or not all(0 <= t < engine.cfg.vocab_size for d in draws
                                                                 for t in d):
        fail(f"{label}: replays of the captured step drew {draws}, generator offset +{advanced}")

    for i in range(b):
        engine.queue.put(Request([256] + [65 + i] * 99, max_tokens=10_000, temperature=0.8 * (i % 2)))
    while not engine.active.all():
        if engine._admit() == 0:
            fail(f"{label}: admission failed")
    for _ in range(4):
        engine._step()
    dispatch, dispatch_s = engine._dispatch, []

    def checked():
        t = time.perf_counter()
        launched = sync_free(dispatch)
        dispatch_s.append(time.perf_counter() - t)
        return launched

    engine._dispatch = checked
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for _ in range(16):
            engine._step()
        engine._flush()
    finally:
        del engine._dispatch
    steady_ms = 1e3 * (time.perf_counter() - t0) / 16
    dispatch_ms = 1e3 * statistics.median(dispatch_s)
    for slot in range(b):
        engine._release_slot(slot)
    print(f"{label}: {len(sampled)} sampled requests inside their masks; 4 replays at temperature 50 drew 4 different "
          f"rows (generator offset +{advanced}); 16 overlapped steps at B={b} with no host sync in their dispatch, "
          f"{steady_ms:.2f} ms a step on the host clock, the dispatch half {dispatch_ms:.3f} ms (median)", flush=True)
    return {"sampled_checked": len(sampled), "draws": draws, "generator_advance": advanced,
            "steady_step_ms": steady_ms, "dispatch_ms": dispatch_ms, "capture_ms": engine._graph.capture_seconds * 1e3}


# The dense path (serve, serve-ckpt's safetensors server, train's artifact
# server); serve-paged drops kv_layout, the JAX entry point's default.
SERVE_PARAMS = {"config": "llama2-7b", "max_batch": 8, "max_seq_len": 1024, "max_prefill_len": 512,
                "kv_cache_dtype": "model", "kv_layout": "dense"}


def serve_phase(card: str, profile_steps: bool = False):
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention

    server, engine, base = start_server("serve", SERVE_PARAMS)
    requests = tee_requests(engine)
    try:
        zero_counts(engine, (flash_attention, decode_attention))
        results, wall = run_concurrent(base, PROMPTS)
        wait_idle(engine)
        launches = {"flash_fwd": launched(engine, flash_attention),
                    "flash_fwd_wgmma": launched(engine, flash_attention, "launches_wgmma"),
                    "decode_attn": launched(engine, decode_attention),
                    "decode_attn_split": launched(engine, decode_attention, "launches_split")}
        stats = dict(engine.stats)
        del engine.submit
        reference = reference_check(engine)
    finally:
        server.stop()

    generated = check_usage(PROMPTS, results)
    L = engine.cfg.n_layers
    if stats["prefills"] != len(PROMPTS):
        fail(f"{stats['prefills']} prefills for {len(PROMPTS)} requests")
    check_graph_run(engine, stats, "serve")
    if (launches["flash_fwd"] != L * stats["prefills"] or launches["decode_attn"] != L * stats["decode_steps"]
            or launches["flash_fwd_wgmma"] != launches["flash_fwd"]
            or launches["decode_attn_split"] != launches["decode_attn"]):
        fail(f"launches {launches} against {L} x {stats['prefills']} prefills (all of the wgmma design, "
             f"head_dim 128) and {L} x {stats['decode_steps']} decode steps (all of the split design)")
    if launches["flash_fwd"] == 0 or launches["decode_attn"] == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    ttft = stats["prefill_seconds"] / stats["prefills"]
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    decode_tps = (generated - len(PROMPTS)) / stats["decode_seconds"]
    print(f"serve: {len(PROMPTS)} concurrent requests, {generated} tokens in {wall:.2f} s; "
          f"{stats['prefills']} prefills, {stats['decode_steps']} decode steps; launches {launches}", flush=True)
    print(f"serve [{card}]: mean prefill (TTFT on the engine) {ttft * 1e3:.1f} ms, "
          f"decode {decode_tps:.1f} tokens/s, mean step {step_ms:.2f} ms (overlapped, the step one CUDA graph)",
          flush=True)
    eager = eager_check(engine, requests, "serve")
    graph = graph_checks(engine, requests, "serve")
    profiled = profile_engine(engine) if profile_steps else None
    return {"launches": launches, "stats": stats, "wall_s": wall, "generated": generated,
            "ttft_ms": ttft * 1e3, "decode_tokens_per_s": decode_tps, "step_ms": step_ms,
            "requests": [r[1] for r in results], "reference": reference, "eager_sync": eager, "graph": graph,
            "profile": profiled}


def _long_text(n_bytes: int, seed: int) -> str:
    rng = random.Random(seed)
    words = ["the", "cache", "of", "a", "long", "prompt", "runs", "in", "chunks", "through",
             "flash", "kernel", "served", "tokens", "decode", "step", "card", "model"]
    text = ""
    while len(text) < n_bytes:
        text += rng.choice(words) + " "
    return text[:n_bytes]


# Long prompts through the chunked prefill: (text, max_tokens, temperature,
# stream); ByteTokenizer ids = 1 + bytes, so 3000 / 1500 / 600 / 40 tokens,
# which max_prefill_len=512 runs as 6 / 3 / 2 chunks and one single-shot
# prefill. The 3000-token request is streamed for its time to first token.
LONG_PARAMS = {"config": "llama2-7b", "max_batch": 8, "max_seq_len": 4096, "max_prefill_len": 512,
               "kv_cache_dtype": "model", "decode_attn_impl": "fused", "chunk_attn_impl": "flash"}
LONG_PROMPTS = [
    (_long_text(2999, 1), 32, 0.0, True),
    (_long_text(1499, 2), 32, 0.0, False),
    (_long_text(599, 3), 32, 0.0, False),
    (_long_text(39, 4), 32, 0.0, False),
]


class _TeeQueue(queue.Queue):
    """A request's token queue that also keeps every token it delivers,
    and the host clock of each."""

    def __init__(self):
        super().__init__()
        self.tokens = []
        self.times = []

    def put(self, item, block=True, timeout=None):
        if item is not None:
            self.tokens.append(item)
            self.times.append(time.perf_counter())
        super().put(item, block, timeout)


def tee_requests(engine) -> list:
    """Keep every request the engine is handed from now on, each token
    queue a _TeeQueue; `del engine.submit` ends it."""
    requests = []
    submit = engine.submit

    def tee_submit(req):
        req.out = _TeeQueue()
        requests.append(req)
        return submit(req)

    engine.submit = tee_submit
    return requests


def long_reference_check(engine, requests, label: str = "serve-long", quiet: bool = False) -> dict:
    """Each served greedy token (chunked prefill + fused decode) within 5%
    of the logit scale of the best logit of one teacher-forced single-shot
    forward (flash prefill, no cache) over prompt + served tokens, on the
    engine's own weights and family. quiet: one line for all requests."""
    import torch

    out = []
    for req in requests:
        prompt, toks = engine.clipped_prompt(req.prompt_tokens), req.out.tokens
        seq = torch.tensor([prompt + toks[:-1]], device=engine.device)
        with torch.inference_mode():
            logits, _ = engine.model.forward(engine.params, seq, engine.cfg)
        logits = logits[0, len(prompt) - 1:]
        if not torch.isfinite(logits).all():
            fail(f"{label}: non-finite logits in the reference of a {len(prompt)}-token prompt")
        scale = logits.abs().max().item()
        gaps = logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]
        agree = sum(int(logits[i].argmax()) == t for i, t in enumerate(toks))
        out.append({"prompt_tokens": len(prompt), "tokens": len(toks), "argmax_agree": agree,
                    "max_gap": gaps.max().item(), "logit_scale": scale})
        if not quiet:
            print(f"{label} reference: {len(prompt)}-token prompt, {agree}/{len(toks)} served greedy tokens are "
                  f"the argmax of the single-shot forward (largest gap {gaps.max().item():.4g} at logit scale "
                  f"{scale:.4g})", flush=True)
        if not toks or gaps.max().item() > 0.05 * scale:
            fail(f"{label}: served tokens disagree with the single-shot reference: {out[-1]}")
    if quiet:
        worst = max(out, key=lambda r: r["max_gap"] / r["logit_scale"])
        print(f"{label} reference: {sum(r['argmax_agree'] for r in out)}/{sum(r['tokens'] for r in out)} served "
              f"greedy tokens of {len(out)} requests are the argmax of the single-shot forward; largest gap "
              f"{worst['max_gap']:.4g} at logit scale {worst['logit_scale']:.4g}", flush=True)
    return {"requests": out}


def serve_long_phase(card: str, profile_steps: bool = False):
    """Long prompts on the dense cache: chunked prefill through the cached
    flash kernel, decode through the fused kernel, llama2-7b at
    max_seq_len 4096 (a 17.2 GB bf16 cache beside 13.5 GB of weights)."""
    import torch

    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_attention
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention

    gc.collect()  # the serve phase's server and cache
    torch.cuda.empty_cache()
    server, engine, base = start_server("serve-long", LONG_PARAMS)
    counters = {"flash_cached": flash_cached_attention, "fused_decode": fused_decode_attention,
                "flash_fwd": flash_attention, "decode_attn": decode_attention}
    requests = tee_requests(engine)
    try:
        zero_counts(engine, counters.values())
        results, wall = run_concurrent(base, LONG_PROMPTS)
        wait_idle(engine)
        launches = {name: launched(engine, c) for name, c in counters.items()}
        launches.update(flash_cached_wgmma=launched(engine, flash_cached_attention, "launches_wgmma"),
                        flash_fwd_wgmma=launched(engine, flash_attention, "launches_wgmma"),
                        fused_decode_split=launched(engine, fused_decode_attention, "launches_split"))
        stats = dict(engine.stats)
    finally:
        server.stop()
    generated = check_usage(LONG_PROMPTS, results)
    del engine.submit
    check_graph_run(engine, stats, "serve-long")
    L = engine.cfg.n_layers
    want = {"flash_cached": L * stats["prefill_chunks"], "flash_fwd": L * stats["prefills"],
            "fused_decode": L * stats["decode_steps"], "decode_attn": 0,
            # the bf16 cache and head_dim 128: every chunk and prefill on the wgmma
            # design, every decode step on the split design
            "flash_cached_wgmma": L * stats["prefill_chunks"], "flash_fwd_wgmma": L * stats["prefills"],
            "fused_decode_split": L * stats["decode_steps"]}
    chunk = LONG_PARAMS["max_prefill_len"]
    lengths = [len(text.encode()) + 1 for text, *_ in LONG_PROMPTS]
    chunks = sum(-(-n // chunk) for n in lengths if n > chunk)  # 6 + 3 + 2
    singles = sum(n <= chunk for n in lengths)
    if launches != want or (stats["prefill_chunks"], stats["prefills"]) != (chunks, singles):
        fail(f"serve-long: launches {launches} against {want}; stats {stats}, want {chunks} chunks "
             f"and {singles} single-shot prefills")
    if not all(launches[name] > 0 for name in ("flash_cached", "fused_decode", "flash_fwd")):
        fail(f"serve-long: a kernel of the path never launched: {launches}")
    reference = long_reference_check(engine, requests)
    # One prompt of 3 chunks written into a free slot with every host sync
    # an error: the chunks' cache writes read nothing back.
    prompt = next(r.prompt_tokens for r in requests if len(r.prompt_tokens) == 1500)
    chunks = engine.stats["prefill_chunks"]
    torch.cuda.synchronize()
    logits = sync_free(engine._chunked_prefill, prompt, 0)
    if engine.stats["prefill_chunks"] - chunks != 3 or not torch.isfinite(logits).all():
        fail(f"serve-long: the sync-free chunked prefill ran {engine.stats['prefill_chunks'] - chunks} chunks")
    print(f"serve-long: a {len(prompt)}-token prompt's 3 chunks with no host sync", flush=True)
    graph = graph_checks(engine, requests, "serve-long")
    profiled = profile_engine(engine, "profile-long", (40, 3000), 1000, alt_decode="kernel") if profile_steps else None
    ttft = results[0][2]
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    decode_tps = (generated - len(LONG_PROMPTS)) / stats["decode_seconds"]
    print(f"serve-long: {len(LONG_PROMPTS)} concurrent requests ({', '.join(str(len(p[0]) + 1) for p in LONG_PROMPTS)}"
          f" prompt tokens), {generated} tokens in {wall:.2f} s; {stats['prefill_chunks']} prefill chunks, "
          f"{stats['prefills']} single-shot prefill, {stats['decode_steps']} decode steps; launches {launches}",
          flush=True)
    print(f"serve-long [{card}]: TTFT of the 3000-token request {ttft * 1e3:.1f} ms (client, streamed), "
          f"engine prefill time {stats['prefill_seconds'] * 1e3:.1f} ms in all, decode {decode_tps:.1f} tokens/s, "
          f"mean step {step_ms:.2f} ms (overlapped, the step one CUDA graph)", flush=True)
    return {"launches": launches, "stats": stats, "wall_s": wall, "generated": generated,
            "ttft_3000_ms": ttft * 1e3, "decode_tokens_per_s": decode_tps, "step_ms": step_ms,
            "requests": [r[1] for r in results], "reference": reference, "graph": graph, "profile": profiled}


# The JAX package's throughput stack (int4 weights, int8 cache, fused
# decode) at llama2-7b's full width and depth: serve's five prompts and one
# greedy 1500-token prompt, which max_prefill_len=512 runs as 3 chunks,
# streamed for its time to first token.
INT4_PARAMS = {"config": "llama2-7b", "quantize": "int4", "kv_cache_dtype": "int8", "decode_attn_impl": "fused",
               "chunk_attn_impl": "flash", "max_batch": 8, "max_seq_len": 2048, "max_prefill_len": 512}
INT4_PROMPTS = PROMPTS + [(_long_text(1499, 5), 32, 0.0, True)]


def int4_counters() -> dict:
    """The kernel wrappers whose launches the int4 serving path counts."""
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_attention
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention
    from substratus_tpu_torch.ops.quant4 import q4_matmul

    return {"q4_matmul": q4_matmul, "flash_fwd": flash_attention, "flash_cached": flash_cached_attention,
            "fused_decode": fused_decode_attention, "decode_attn": decode_attention}


def int4_launches(engine, counters) -> dict:
    """Each int4-path counter's launches since zero_counts, and per design."""
    from substratus_tpu_torch.ops.flash_attention import flash_cached_design

    launches = {name: launched(engine, c) for name, c in counters.items()}
    q4, flash, cached, fused = (counters[n] for n in ("q4_matmul", "flash_fwd", "flash_cached", "fused_decode"))
    # q4_matmul_decode: the decode design; q4_matmul_wgmma: the prefill
    # design; q4_matmul: q4_matmul.cu's kernel (no shape of this path)
    launches.update(q4_matmul_decode=launched(engine, q4, "launches_decode"),
                    q4_matmul=launched(engine, q4, "launches_mma"),
                    q4_matmul_wgmma=launched(engine, q4, "launches_wgmma"),
                    q4_matmul_total=launched(engine, q4),
                    flash_fwd_wgmma=launched(engine, flash, "launches_wgmma"),
                    # the int8 cache's chunks, of the design flash_cached_design names
                    flash_cached_int8=launched(engine, cached, f"launches_{flash_cached_design(128)}"),
                    fused_decode_split=launched(engine, fused, "launches_split"))
    return launches


def check_int4_launches(engine, stats, launches, lengths, label: str, per_layer: int = 7) -> None:
    """The int4 path's launches against what the requests' prompt lengths
    (in tokens) and the engine's stats ask for: every projection (per_layer
    a layer: 7 dense, 4 + 3 x E under a mixture of experts, one launch an
    expert) and the lm_head of every forward once through the int4 matmul,
    by design."""
    from substratus_tpu_torch.ops.quant4 import WGMMA_MIN_M
    from substratus_tpu_torch.serve.engine import _bucket

    L = engine.cfg.n_layers
    forwards = stats["prefills"] + stats["prefill_chunks"] + stats["decode_steps"]
    chunk = engine.ec.max_prefill_len
    chunks = sum(-(-n // chunk) for n in lengths if n > chunk)
    singles = sum(n <= chunk for n in lengths)
    if engine.paged:
        # Every paged prompt runs as chunks through its block-table row
        # (a short one as one chunk of its bucket), with no prefix shared
        # here, and every chunk and decode step attends the gathered pages
        # with the plain attention: no attention kernel launches.
        if stats["prefix_hit_tokens"]:
            fail(f"{label}: {stats['prefix_hit_tokens']} prefix-hit tokens; the rows below assume none")
        chunks, singles = chunks + singles, 0
    # Rows of each prefill forward: a prompt's bucket, or each chunk's
    # (capped at the chunk); a decode step has max_batch rows. Every
    # llama2-7b projection takes the wgmma design above WGMMA_MIN_M rows
    # and the decode design up to it.
    rows = [min(_bucket(n), chunk) for n in lengths if n <= chunk]
    rows += [min(_bucket(min(chunk, n - o)), chunk) for n in lengths if n > chunk for o in range(0, n, chunk)]
    wide = sum(r > WGMMA_MIN_M for r in rows)
    attn = 0 if engine.paged else L
    per_forward = per_layer * L + 1
    want = {"q4_matmul_decode": per_forward * (forwards - wide), "q4_matmul": 0, "q4_matmul_wgmma": per_forward * wide,
            "q4_matmul_total": per_forward * forwards, "flash_fwd": attn * stats["prefills"],
            "flash_cached": attn * stats["prefill_chunks"], "fused_decode": attn * stats["decode_steps"],
            "decode_attn": 0, "flash_fwd_wgmma": attn * stats["prefills"],
            "flash_cached_int8": attn * stats["prefill_chunks"], "fused_decode_split": attn * stats["decode_steps"]}
    print(f"{label}: prefill forwards of {rows} rows; {wide} of them above {WGMMA_MIN_M} rows take the wgmma "
          f"design ({want['q4_matmul_wgmma']} launches), the other {forwards - wide} forwards (decode steps of "
          f"{engine.ec.max_batch} rows included) the decode design ({want['q4_matmul_decode']}), none "
          "q4_matmul.cu's kernel", flush=True)
    if launches != want or (stats["prefill_chunks"], stats["prefills"]) != (chunks, singles):
        fail(f"{label}: launches {launches} against {want}; stats {stats}, want {chunks} chunks "
             f"and {singles} single-shot prefills")
    path = ("q4_matmul_decode", "q4_matmul_wgmma") + (() if engine.paged else ("flash_fwd", "flash_cached",
                                                                                "fused_decode"))
    if not all(launches[name] > 0 for name in path):
        fail(f"{label}: a kernel of the path never launched: {launches}")


def serve_int4_phase(card: str, profile_steps: bool = False):
    """int4 weights through serve.main: every projection and the lm_head
    of every forward (single-shot prefill, chunk or decode step) launch
    the int4 matmul once; the served greedy tokens are held against a
    single-shot forward on the same int4 weights."""
    import torch

    from substratus_tpu_torch.ops.quant import is_quantized

    gc.collect()  # the earlier phases' servers and caches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server, engine, base = start_server("serve-int4", INT4_PARAMS)
    params = engine.params
    nbytes = {"weights": sum(t.numel() * t.element_size() for t in params.state_dict().values()
                             if isinstance(t, torch.Tensor)),
              "cache": sum(t.numel() * t.element_size() for t in engine.cache.values()),
              "allocated": torch.cuda.memory_allocated(), "peak_while_building": torch.cuda.max_memory_allocated()}
    print(f"serve-int4: bytes on the card after quantization: {nbytes['weights']} of weights (int4 projections "
          f"and lm_head, bf16 tok_embed and norms), {nbytes['cache']} of int8 cache, {nbytes['allocated']} "
          f"allocated in all; peak {nbytes['peak_while_building']} while the bf16 weights were quantized",
          flush=True)
    if not is_quantized(params.layers[0].wq) or not is_quantized(params.lm_head):
        fail("serve-int4: the weights were not quantized")
    counters = int4_counters()
    requests = tee_requests(engine)
    try:
        zero_counts(engine, counters.values())
        results, wall = run_concurrent(base, INT4_PROMPTS)
        wait_idle(engine)
        launches = int4_launches(engine, counters)
        stats = dict(engine.stats)
    finally:
        server.stop()
    generated = check_usage(INT4_PROMPTS, results)
    del engine.submit
    check_graph_run(engine, stats, "serve-int4")
    check_int4_launches(engine, stats, launches, [len(text.encode()) + 1 for text, *_ in INT4_PROMPTS], "serve-int4")
    reference = long_reference_check(engine, [r for r in requests if r.temperature == 0.0], "serve-int4")
    eager = eager_check(engine, requests, "serve-int4")
    graph = graph_checks(engine, requests, "serve-int4")
    profiled = profile_engine(engine, "profile-int4", (16, 1500)) if profile_steps else None
    if profiled is not None and profiled["decode"]["q4_splitk_ms"]:
        fail(f"profile-int4: a decode step ran q4_matmul.cu's split-K sums ({profiled['decode']['q4_splitk_ms']} ms)")
    ttft = results[-1][2]
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    decode_tps = (generated - len(INT4_PROMPTS)) / stats["decode_seconds"]
    prefill_ms = 1e3 * stats["prefill_seconds"] / len(INT4_PROMPTS)
    print(f"serve-int4: {len(INT4_PROMPTS)} concurrent requests, {generated} tokens in {wall:.2f} s; "
          f"{stats['prefills']} single-shot prefills, {stats['prefill_chunks']} prefill chunks, "
          f"{stats['decode_steps']} decode steps; launches {launches}", flush=True)
    print(f"serve-int4 [{card}]: mean prefill (engine) {prefill_ms:.1f} ms, decode {decode_tps:.1f} tokens/s, "
          f"mean step {step_ms:.2f} ms (overlapped, the step one CUDA graph), TTFT of the 1500-token request "
          f"{ttft * 1e3:.1f} ms (client, streamed)", flush=True)
    return {"launches": launches, "stats": stats, "bytes": nbytes, "wall_s": wall, "generated": generated,
            "prefill_ms": prefill_ms, "decode_tokens_per_s": decode_tps, "step_ms": step_ms,
            "ttft_1500_ms": ttft * 1e3, "requests": [r[1] for r in results], "reference": reference,
            "eager_sync": eager, "graph": graph, "profile": profiled}


# --- the paged pool: serve.main's default for llama ---------------------------

# A shared prefix of 480 tokens (BOS + 479 bytes: 30 full pages of 16)
# under one 32-byte suffix, then under seven of 20-60 bytes; each suffix
# starts with its own bytes, so each later request shares exactly the 30
# prefix pages (the 31st page holds its own suffix).
PAGED_PREFIX = "System: " + _long_text(471, 6)
PAGED_FIRST = (PAGED_PREFIX + "[a] " + _long_text(28, 7), 32, 0.0, False)
PAGED_SEVEN = [(PAGED_PREFIX + f"[{tag}] " + _long_text(n - 4, 8 + i), 32, 0.0, i == 2)
               for i, (tag, n) in enumerate(zip("bcdefgh", (20, 27, 34, 41, 48, 54, 60)))]
PAGED_HIT = 480
# Preempt-and-resume: 8 greedy requests of 100-340 prompt tokens (1800 in
# all), 192 tokens each, against a pool of 2048 tokens (128 pages).
PREEMPT_LENS = (100, 140, 180, 220, 260, 300, 340, 260)
PREEMPT_TOKENS = 192
PREEMPT_POOL = 2048


def check_pages_recovered(engine, label: str) -> None:
    """After idle every page is free or held once by the prefix registry,
    and every block-table row points at the trash page."""
    registry = engine.prefix._map.values() if engine.prefix is not None else ()
    held = [engine.alloc.refs(pid) for pid, _, _ in registry]
    if engine.alloc.free_pages + len(held) != engine.n_pages or any(r != 1 for r in held) or engine.block_table.any():
        fail(f"{label}: {engine.alloc.free_pages} free pages and {len(held)} held by the registry of {engine.n_pages}")


def profile_prefix_hit(engine, label: str) -> dict:
    """Host clock and device busy time of one paged admission of a
    512-token prompt without a prefix hit and of the same prompt again,
    which takes 31 of its 32 pages from the registry (the last token's page
    runs), each under torch.profiler, after an unprofiled admission of
    another 512-token prompt. Driven from this thread on the stopped
    engine; the slots are released after."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from substratus_tpu_torch.serve.engine import Request
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    def admit(prompt, profiled: bool) -> dict:
        engine.queue.put(Request(list(prompt), max_tokens=10_000, temperature=0.0))
        hits = engine.stats["prefix_hit_tokens"]
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities) if profiled else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            if engine._admit() != 1:
                fail(f"{label}: admission failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = {"host_ms": wall * 1e3, "hit_tokens": engine.stats["prefix_hit_tokens"] - hits}
        if profiled:
            out["device_busy_ms"] = _device_summary(prof, wall, 1)["device_busy_ms"]
        return out

    tok = ByteTokenizer()
    admit(tok.encode("Warm: " + _long_text(505, 30)), False)
    prompt = tok.encode("Other: " + _long_text(504, 31))
    miss, hit = admit(prompt, True), admit(prompt, True)
    for slot in np.flatnonzero(engine.active):
        engine._release_slot(int(slot))
    if (miss["hit_tokens"], hit["hit_tokens"], len(prompt)) != (0, 496, 512):
        fail(f"{label}: {miss['hit_tokens']} and {hit['hit_tokens']} prefix-hit tokens of a {len(prompt)}-token prompt")
    print(f"{label}: a 512-token prompt's prefill without a hit {miss['host_ms']:.1f} ms host clock, "
          f"{miss['device_busy_ms']:.2f} ms device busy; again, 496 tokens from the registry, {hit['host_ms']:.1f} ms, "
          f"{hit['device_busy_ms']:.2f} ms", flush=True)
    return {"miss": miss, "hit": hit}


def paged_default_leg(card: str, dense_step_ms, profile_steps: bool):
    """serve.main with serve's knobs and no kv_layout: llama resolves to the
    paged pool, as in the JAX entry point. Returns (report, the weights,
    the config) for the preemption leg."""
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_attention
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention

    params_json = {k: v for k, v in SERVE_PARAMS.items() if k != "kv_layout"}
    server, engine, base = start_server("serve-paged", params_json)
    pool_bytes = sum(t.numel() * t.element_size() for t in engine.cache.values())
    if not engine.paged or engine.page_size != 16 or engine.n_pages != 512 or engine.prefix is None:
        fail(f"serve-paged: the default server is not on a 512-page pool of 16-token pages with a prefix cache "
             f"(paged {engine.paged})")
    # The attention kernels' wrappers, none of which the paged path calls.
    counters = {"decode_attn": decode_attention, "fused_decode": fused_decode_attention, "flash_fwd": flash_attention,
                "flash_cached": flash_cached_attention}
    requests = tee_requests(engine)
    try:
        zero_counts(engine, counters.values())
        first, _ = run_concurrent(base, [PAGED_FIRST])
        wait_idle(engine)
        first_s = engine.stats["prefill_seconds"]
        seven, _ = run_concurrent(base, PAGED_SEVEN)
        wait_idle(engine)
        seven_s, seven_hits = engine.stats["prefill_seconds"] - first_s, engine.stats["prefix_hit_tokens"]
        rest, _ = run_concurrent(base, PROMPTS)
        wait_idle(engine)
        launches = {name: launched(engine, c) for name, c in counters.items()}
        stats = dict(engine.stats)
    finally:
        server.stop()
    del engine.submit
    traffic = [PAGED_FIRST] + PAGED_SEVEN + PROMPTS
    generated = sum(check_usage(p, r) for p, r in (([PAGED_FIRST], first), (PAGED_SEVEN, seven), (PROMPTS, rest)))
    check_graph_run(engine, stats, "serve-paged")
    true_lens = [len(text.encode()) + 1 for text, *_ in traffic]
    hits = len(PAGED_SEVEN) * PAGED_HIT
    if (stats["prefix_hit_tokens"], seven_hits, stats["prefill_tokens"]) != (hits, hits, sum(true_lens) - hits):
        fail(f"serve-paged: {stats['prefix_hit_tokens']} prefix-hit tokens ({seven_hits} by the seven), "
             f"{stats['prefill_tokens']} prefilled; want {hits} and {sum(true_lens) - hits}")
    if stats["prefills"] or stats["prefill_chunks"] != len(traffic) or stats["preemptions"]:
        fail(f"serve-paged: every prompt must be one chunk through its block-table row, none preempted: {stats}")
    if any(launches.values()):
        fail(f"serve-paged: an attention kernel launched on the paged path: {launches}")
    check_pages_recovered(engine, "serve-paged")
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    decode_tps = (generated - len(traffic)) / stats["decode_seconds"]
    print(f"serve-paged: {len(traffic)} requests ({true_lens[0]} tokens alone, then {len(PAGED_SEVEN)} concurrent "
          f"sharing its {PAGED_HIT}-token prefix, then serve's {len(PROMPTS)}), {generated} tokens; "
          f"{stats['prefix_hit_tokens']} prefix-hit tokens, {stats['prefill_tokens']} prefilled in "
          f"{stats['prefill_chunks']} chunks, {stats['decode_steps']} decode steps, the most slots active "
          f"{stats['max_active']}; attention kernel launches {launches}", flush=True)
    print(f"serve-paged [{card}]: the pool {pool_bytes} bytes ({engine.n_pages} pages and the trash page); prefill "
          f"of the first request (no hit) {first_s * 1e3:.1f} ms, of the {len(PAGED_SEVEN)} that hit "
          f"{seven_s / len(PAGED_SEVEN) * 1e3:.1f} ms each on average; mean decode step {step_ms:.2f} ms, "
          f"decode {decode_tps:.1f} tokens/s (overlapped, the step one CUDA graph); serve's dense step in this run "
          f"{'not run' if dense_step_ms is None else f'{dense_step_ms:.2f} ms'}", flush=True)
    reference = long_reference_check(engine, [r for r in requests if r.temperature == 0.0], "serve-paged")
    eager = eager_check(engine, requests, "serve-paged")
    graph = graph_checks(engine, requests, "serve-paged")
    profiled = None
    if profile_steps:
        hit_profile = profile_prefix_hit(engine, "profile-paged")
        # Each of the profile's prefills runs in full: its repeated prompts
        # would otherwise take their pages from the registry.
        engine.prefix = None
        profiled = dict(profile_engine(engine, "profile-paged", (16, 512)), prefix_hit=hit_profile)
    report = {"launches": launches, "stats": stats, "pool_bytes": pool_bytes, "generated": generated,
              "first_prefill_ms": first_s * 1e3, "hit_prefill_ms": seven_s / len(PAGED_SEVEN) * 1e3,
              "step_ms": step_ms, "decode_tokens_per_s": decode_tps, "dense_step_ms": dense_step_ms,
              "requests": [r[1] for r in first + seven + rest], "reference": reference, "eager_sync": eager,
              "graph": graph, "profile": profiled}
    return report, engine.params, engine.cfg


def paged_preempt_leg(card: str, params, cfg) -> dict:
    """The default engine (overlapped, the step a CUDA graph) on a pool of
    2048 tokens without the prefix cache, under more demand than it holds:
    the youngest slots are preempted and resumed with prompt + generated
    tokens. Every request is held by the teacher-forced reference (a
    re-prefill in bf16 rounds unlike the decode steps that wrote the
    same entries, so not by equality with a roomy run)."""
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    ec = EngineConfig(max_batch=8, max_seq_len=1024, max_prefill_len=512, kv_layout="paged",
                      kv_pool_tokens=PREEMPT_POOL, prefix_cache=False, eos_token_id=tok.eos_id)
    engine = Engine(cfg, params, ec)
    prompts = [tok.encode(_long_text(n - 1, 20 + i)) for i, n in enumerate(PREEMPT_LENS)]
    reqs = [Request(list(p), max_tokens=PREEMPT_TOKENS, temperature=0.0, out=_TeeQueue()) for p in prompts]
    preempted, preempt = [], engine._preempt

    def record(victim):
        preempted.append(engine.slot_req[victim])
        preempt(victim)

    engine._preempt = record
    engine.start()
    t0 = time.perf_counter()
    try:
        for req in reqs:
            engine.submit(req)
        for req in reqs:
            while req.out.get(timeout=600) is not None:
                pass
    finally:
        engine.stop()
    wall = time.perf_counter() - t0
    stats = dict(engine.stats)
    demand = sum(PREEMPT_LENS) + len(PREEMPT_LENS) * PREEMPT_TOKENS
    for req in reqs:
        if not (req.finish_reason == "stop" or len(req.out.tokens) == PREEMPT_TOKENS):
            fail(f"serve-paged preempt: a request ended {req.finish_reason} after {len(req.out.tokens)} tokens")
    if stats["preemptions"] < 1 or stats["truncated_by_pool"] or engine.error is not None:
        fail(f"serve-paged preempt: {stats['preemptions']} preemptions, {stats['truncated_by_pool']} truncated "
             f"for {demand} tokens of demand on a {PREEMPT_POOL}-token pool ({engine.error})")
    if engine._graph is None or engine._graph.graph is None or stats["graph_replays"] != stats["decode_steps"]:
        fail(f"serve-paged preempt: {stats['decode_steps']} steps, {stats['graph_replays']} replays of the graph")
    check_pages_recovered(engine, "serve-paged preempt")
    # The references: each request's own prompt and every token it delivered
    # (a preempted request resumed with its delivered tokens appended).
    for req, prompt in zip(reqs, prompts):
        req.prompt_tokens = prompt
    reference = long_reference_check(engine, reqs, "serve-paged preempt")
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    victims = len({id(r) for r in preempted})
    print(f"serve-paged preempt [{card}]: {len(reqs)} greedy requests ({sum(PREEMPT_LENS)} prompt tokens, "
          f"{PREEMPT_TOKENS} tokens each: {demand} tokens of demand) on a {PREEMPT_POOL}-token pool "
          f"({engine.n_pages} pages): {stats['preemptions']} preemptions of {victims} requests, none truncated, "
          f"{stats['prefill_chunks']} prefill chunks ({stats['prefill_tokens']} tokens, the resumed prompts' "
          f"included), {stats['decode_steps']} decode steps, mean step {step_ms:.2f} ms, the most slots active "
          f"{stats['max_active']}, {wall:.2f} s in all; every request, the {victims} preempted ones included, "
          "held by the reference", flush=True)
    return {"stats": stats, "wall_s": wall, "demand_tokens": demand, "preempted_requests": victims,
            "step_ms": step_ms, "reference": reference}


def paged_int4_leg(card: str, profile_steps: bool) -> dict:
    """serve-int4's weights and int8 cache on int8 pages (kv_layout paged,
    no fused decode) at window 2048: every projection and the lm_head of
    every chunk and decode step through the int4 matmul, by design."""
    import torch

    params_json = {**{k: v for k, v in INT4_PARAMS.items() if k != "decode_attn_impl"}, "kv_layout": "paged"}
    server, engine, base = start_server("serve-paged-int4", params_json)
    if not engine.paged or engine.cache["k"].dtype != torch.int8:
        fail("serve-paged int4: the server is not on an int8 page pool")
    counters = int4_counters()
    requests = tee_requests(engine)
    try:
        zero_counts(engine, counters.values())
        results, wall = run_concurrent(base, INT4_PROMPTS)
        wait_idle(engine)
        launches = int4_launches(engine, counters)
        stats = dict(engine.stats)
        del engine.submit
        reference = reference_check(engine)
    finally:
        server.stop()
    generated = check_usage(INT4_PROMPTS, results)
    check_graph_run(engine, stats, "serve-paged int4")
    check_int4_launches(engine, stats, launches, [len(text.encode()) + 1 for text, *_ in INT4_PROMPTS],
                        "serve-paged int4")
    long_ref = long_reference_check(engine, [r for r in requests if r.temperature == 0.0], "serve-paged int4")
    check_pages_recovered(engine, "serve-paged int4")
    profiled = None
    if profile_steps:
        engine.prefix = None  # each of the profile's prefills in full, as in leg (a)
        profiled = profile_engine(engine, "profile-paged-int4", (16, 1500))
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    print(f"serve-paged int4 [{card}]: {len(INT4_PROMPTS)} requests, {generated} tokens in {wall:.2f} s; "
          f"{stats['prefill_chunks']} prefill chunks, {stats['decode_steps']} decode steps, mean step "
          f"{step_ms:.2f} ms; launches {launches}", flush=True)
    return {"launches": launches, "stats": stats, "wall_s": wall, "generated": generated, "step_ms": step_ms,
            "reference": reference, "long_reference": long_ref, "profile": profiled}


def serve_paged_phase(card: str, dense_step_ms=None, profile_steps: bool = False) -> dict:
    """The JAX server's default for llama, the paged pool, in three legs:
    serve.main with no kv_layout (prefix reuse), preempt-and-resume on a
    small pool, and the int4 stack on int8 pages."""
    import torch

    gc.collect()  # the earlier phases' servers and caches
    torch.cuda.empty_cache()
    out = {}
    out["default"], params, cfg = paged_default_leg(card, dense_step_ms, profile_steps)
    gc.collect()
    torch.cuda.empty_cache()
    out["preempt"] = paged_preempt_leg(card, params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["int4"] = paged_int4_leg(card, profile_steps)
    return out


# --- speculative decoding: prompt lookup and a draft model ---------------------

# examples/llama2-7b/server-throughput.yaml's params as written: no
# kv_layout (the paged pool) and serve.main's default max_seq_len, 1024.
SPEC_PARAMS = {"config": "llama2-7b", "quantize": "int4", "kv_cache_dtype": "int8", "max_batch": 24, "spec_k": 3}
# The phase's depth: llama2-7b's width at 4 of its 32 layers in every leg,
# cut so that the default run stays well inside its time limit (8, then 4
# once serve-gang's llama2-70b leg joined it; every check as at full depth;
# the draft leg's target too).
SPEC_LAYERS = 4


def _repeat_text(i: int, n_bytes: int) -> str:
    """A repetitive prompt, one phrase again and again: prompt lookup finds
    the context's trailing n-grams earlier in it."""
    phrase = f"step {i}: read the page, write the token, then read the page again. "
    return (phrase * (n_bytes // len(phrase) + 1))[:n_bytes]


# Legs (a) and (b): 24 requests of 64 tokens, 12 repetitive (61-336
# tokens) and serve's five prompts cycled (16-411 tokens; the one at
# temperature 0.8 twice).
SPEC_PROMPTS = ([(_repeat_text(i, 60 + 25 * i), 64, 0.0, i == 0) for i in range(12)]
                + [(PROMPTS[j % 5][0] + ("" if j < 5 else f" (again, {j})"), 64, PROMPTS[j % 5][2], False)
                   for j in range(12)])
# Leg (c): serve's five prompts and three repetitive ones.
DRAFT_PROMPTS = PROMPTS + [(_repeat_text(20 + i, 120 + 60 * i), 32, 0.0, False) for i in range(3)]
# The per-design counters a spec leg reads: name -> (kernel wrapper, counter).
SPEC_DESIGNS = {"q4_matmul_decode": ("q4_matmul", "launches_decode"),
                "q4_matmul_wgmma": ("q4_matmul", "launches_wgmma"), "q4_matmul": ("q4_matmul", "launches_mma"),
                "flash_cached_int8": ("flash_cached_attention", "launches_wgmma"),
                "fused_decode_split": ("fused_decode_attention", "launches_split"),
                "flash_fwd_wgmma": ("flash_attention", "launches_wgmma"),
                "decode_attn_split": ("decode_attention", "launches_split")}


def prime_spec_graphs(engine) -> None:
    """Capture every graph of a spec engine before a timed run: one round
    of each width launched on the idle engine (its rows write only into
    the trash page, or into idle slots' regions, which an admission
    overwrites before any read). A started engine's scheduler thread
    idles meanwhile: it only polls an empty queue."""
    import numpy as np

    engine._flush()  # an idle scheduler may still hold its last round, unread
    graph, b, k = engine._decode_graph(), engine.ec.max_batch, engine.ec.spec_k
    props = None if engine.spec_draft else np.zeros((b, k), np.int64)
    pages = {"block_table": engine.block_table} if engine.paged else {}
    for width in range(1, k + 2):
        graph.launch(engine.tokens, engine.positions, engine.temps, engine.top_ps, np.ones(b, bool),
                     np.zeros(b, np.int64), np.zeros(b, bool), width, props=props, **pages)()


def spec_launches(engine) -> dict:
    """Each design's launches since zero_counts: "total" (the wrappers'
    own, the prefills', plus the replays'), and per graph of the engine's
    SpecGraph its replays'."""
    wrappers = {fn.__name__: fn for fn in int4_counters().values()}
    total, per_graph = {}, {}
    for name, (fn, attr) in SPEC_DESIGNS.items():
        total[name] = launched(engine, wrappers[fn], attr)
        for key, launches in engine._graph.captured.items():
            n = launches.get(f"{fn}.{attr}", 0) * int(engine.stats.get(f"replays_{key}", 0))
            if n:
                per_graph.setdefault(key, {})[name] = n
    return {"total": total, "per_graph": per_graph}


def warm_by_hand(engine, prompt) -> None:
    """Capture an engine's graphs before a timed run: one greedy request of
    24 tokens driven by hand, the scheduler not started."""
    from substratus_tpu_torch.serve.engine import Request

    engine.queue.put(Request(list(prompt), max_tokens=24, temperature=0.0))
    if engine._admit() != 1:
        fail("warm-up: admission failed")
    while engine.active.any():
        engine._step()
    engine._flush()


def serve_all(engine, prompts, specs) -> tuple:
    """Submit a Request for each prompt (token ids; max_tokens and
    temperature from `specs`' (text, max_tokens, temperature, stream)),
    each token queue a _TeeQueue, before the scheduler starts: its first
    iteration admits them together, so the schedule repeats from run to
    run. Start it, wait for every stream, stop it. Returns (requests,
    seconds from the start to the last token)."""
    from substratus_tpu_torch.serve.engine import Request

    reqs = [engine.submit(Request(list(p), max_tokens=mt, temperature=temp, out=_TeeQueue()))
            for p, (_, mt, temp, _) in zip(prompts, specs)]
    t0 = time.perf_counter()
    engine.start()
    try:
        for req in reqs:
            while req.out.get(timeout=600) is not None:
                pass
        wall = time.perf_counter() - t0
        wait_idle(engine)
    finally:
        engine.stop()
    return reqs, wall


def run_summary(engine, stats, reqs, label: str, card: str) -> dict:
    """Decode tokens/s, mean round (step) ms and, for a spec engine, the
    verify passes, proposals, acceptance and rounds and replays by width."""
    decode_tokens = sum(len(r.out.tokens) - 1 for r in reqs)  # the first token comes from the prefill
    # What one greedy stream sees: its tokens after the first over the host
    # clock from its first token to its last, averaged over the streams.
    streams = [(len(r.out.tokens) - 1) / (r.out.times[-1] - r.out.times[0]) for r in reqs
               if r.temperature == 0.0 and len(r.out.tokens) > 1 and r.out.times[-1] > r.out.times[0]]
    out = {"decode_tokens": decode_tokens, "decode_steps": stats["decode_steps"],
           "round_ms": 1e3 * stats["decode_seconds"] / stats["decode_steps"],
           "decode_tokens_per_s": decode_tokens / stats["decode_seconds"],
           "tokens_per_round": decode_tokens / stats["decode_steps"],
           "stream_tokens_per_s": statistics.mean(streams) if streams else None}
    line = (f"{label} [{card}]: {len(reqs)} requests, {decode_tokens} decode tokens in {stats['decode_steps']} "
            f"{'rounds' if engine.spec else 'steps'}, mean {out['round_ms']:.2f} ms, {out['decode_tokens_per_s']:.1f} "
            f"decode tokens/s, a greedy stream's own {out['stream_tokens_per_s'] or float('nan'):.1f} tokens/s "
            f"(mean of {len(streams)})")
    if engine.spec:
        k = engine.ec.spec_k
        out.update({key: stats[key] for key in ("verify_passes", "spec_proposed", "spec_accepted")},
                   rounds_by_width={w: stats[f"rounds_w{w}"] for w in range(1, k + 2)},
                   replays_by_width={w: stats.get(f"replays_verify{w}", 0) for w in range(1, k + 2)},
                   accepted_per_verify=stats["spec_accepted"] / max(1, stats["verify_passes"]))
        line += (f"; {stats['verify_passes']} verify passes, {stats['spec_proposed']} proposed, "
                 f"{stats['spec_accepted']} accepted ({out['accepted_per_verify']:.2f} a verify pass, "
                 f"{out['tokens_per_round']:.2f} tokens a round, over all slots); rounds by width {out['rounds_by_width']}, graph "
                 f"replays by width {out['replays_by_width']}")
    print(line, flush=True)
    return out


def plain_twin(engine, prompts, specs, label: str, card: str) -> dict:
    """The same requests through a plain engine (spec_k 0, the spec
    engine's other knobs, its weights): overlapped, the step one CUDA
    graph, captured at a warm-up request before the counts start."""
    import dataclasses

    from substratus_tpu_torch.serve.engine import Engine

    plain = Engine(engine.cfg, engine.params, dataclasses.replace(engine.ec, spec_k=0), device=engine.device,
                   model=engine.model)
    warm_by_hand(plain, [256] + [65] * 15)
    zero_counts(plain, ())
    reqs, wall = serve_all(plain, prompts, specs)
    stats = dict(plain.stats)
    if plain.paged:
        check_pages_recovered(plain, label)
    out = dict(run_summary(plain, stats, reqs, label, card), wall_s=wall, requests=reqs)
    del plain
    gc.collect()
    return out


def against_plain(engine, reqs, plain_reqs, label: str, what: str = "the plain engine's") -> dict:
    """How many greedy requests are token for token those of another run
    (`what`, by default the plain engine's); for each that is not, the
    first differing token of both runs must be a near-tie: within 5% of
    the logit scale of the best logit of a teacher-forced forward over the
    prompt and the common prefix."""
    import torch

    from substratus_tpu_torch.models import llama

    identical, diffs = 0, []
    for req, twin in zip(reqs, plain_reqs):
        if req.temperature != 0.0:
            continue
        a, b = req.out.tokens, twin.out.tokens
        if a == b:
            identical += 1
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        eos = engine.ec.eos_token_id
        pick = [t[i] if i < len(t) else eos for t in (a, b)]  # a stream that stopped there sampled EOS
        prompt = engine.clipped_prompt(req.prompt_tokens)
        with torch.inference_mode():
            logits, _ = llama.forward(engine.params, torch.tensor([prompt + a[:i]], device=engine.device), engine.cfg)
        row = logits[0, -1]
        scale = row.abs().max().item()
        gaps = [(row.max() - row[t]).item() for t in pick]
        diffs.append({"at": i, "tokens": pick, "gaps": gaps, "logit_scale": scale})
        if max(gaps) > 0.05 * scale:
            fail(f"{label}: a greedy request departs from {what} at token {i} ({pick}) by more than a "
                 f"near-tie: gaps {gaps} at logit scale {scale:.4g}")
    greedy = sum(r.temperature == 0.0 for r in reqs)
    print(f"{label}: {identical} of {greedy} greedy requests token for token {what}"
          + (f"; the others first differ at a near-tie: {[(d['at'], [round(g, 4) for g in d['gaps']]) for d in diffs]}"
             if diffs else ""), flush=True)
    return {"identical": identical, "greedy": greedy, "differ": diffs}


def graph_ms(engine, profile_steps: bool, reps: int = 5) -> dict:
    """Each captured graph's time a replay on the idle engine (the accept
    walk, the draft's steps, each width's verify: CUDA events around
    `reps` replays; with profile also the device busy time under
    torch.profiler). Idle rows write only past their slots' live entries
    (dense) or into the trash page (paged)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for key, graph in sorted(engine._graph.graphs.items()):
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        out[key] = {"event_ms": start.elapsed_time(end) / reps}
        if profile_steps:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    graph.replay()
                torch.cuda.synchronize()
            out[key]["device_busy_ms"] = _device_summary(prof, time.perf_counter() - t0, reps)["device_busy_ms"]
    return out


def card_bytes(engine) -> dict:
    import torch

    def size(values):  # a quantized weight's state also holds its layout's ints
        return sum(v.numel() * v.element_size() for v in values if isinstance(v, torch.Tensor))

    out = {"weights": size(engine.params.state_dict().values()), "cache": size(engine.cache.values()),
           "allocated": torch.cuda.memory_allocated(), "peak": torch.cuda.max_memory_allocated()}
    if engine.spec_draft:
        out.update(draft_weights=size(engine.draft_params.state_dict().values()),
                   draft_cache=size(engine.draft_cache.values()))
    return out


def spec_report(engine, stats, reqs, plain, launches, label: str, card: str, profile_steps: bool) -> dict:
    """A spec run's numbers beside its plain twin's, its checks against the
    plain run and the reference, and its graphs' replay times."""
    spec = run_summary(engine, stats, reqs, label, card)
    greedy = [r for r in reqs if r.temperature == 0.0]
    by_prompt = {tuple(r.prompt_tokens): r for r in plain["requests"]}
    twins = [by_prompt[tuple(r.prompt_tokens)] for r in reqs]
    same = against_plain(engine, reqs, twins, label)
    reference = long_reference_check(engine, greedy, label, quiet=True)
    if engine.paged:
        check_pages_recovered(engine, label)
    if stats["verify_passes"] <= 0:
        fail(f"{label}: no verify pass")
    if engine.decode_graph and (stats["graph_warmups"] or stats["graph_replays"] != stats["decode_steps"]):
        fail(f"{label}: every round must replay graphs captured before the run: {stats}")
    for r in reqs:
        if not r.out.tokens or not (r.finish_reason == "stop" or len(r.out.tokens) == r.max_tokens):
            fail(f"{label}: a request ended {r.finish_reason} after {len(r.out.tokens)} tokens")
    times = graph_ms(engine, profile_steps)
    nbytes = card_bytes(engine)
    print(f"{label} [{card}]: spec against plain: {spec['decode_tokens_per_s']:.1f} against "
          f"{plain['decode_tokens_per_s']:.1f} decode tokens/s ({spec['decode_tokens_per_s'] / plain['decode_tokens_per_s']:.2f}x), "
          f"mean round {spec['round_ms']:.2f} ms against a plain step of {plain['round_ms']:.2f} ms; a greedy "
          f"stream's own {spec['stream_tokens_per_s'] or float('nan'):.1f} against "
          f"{plain['stream_tokens_per_s'] or float('nan'):.1f} tokens/s; each graph a replay: " + ", ".join(f"{k} {v['event_ms']:.2f} ms" + (f" (device busy {v['device_busy_ms']:.2f})"
                                                                     if "device_busy_ms" in v else "")
                                  for k, v in times.items())
          + f"; launches {launches['total']}, by graph {launches['per_graph']}; bytes on the card {nbytes}",
          flush=True)
    plain = {k: v for k, v in plain.items() if k != "requests"}
    return {"spec": spec, "plain": plain, "against_plain": same, "reference": reference, "launches": launches,
            "graph_ms": times, "bytes": nbytes, "stats": stats}


def spec_lookup_leg(card: str, profile_steps: bool):
    """(a) The throughput example through serve.main over HTTP: int4
    weights, int8 pages, max_batch 24, prompt lookup with spec_k 3.
    Returns (report, the weights, the config) for leg (b)."""
    import torch

    from substratus_tpu_torch.ops.quant4 import Q4Tensor
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    label = "serve-spec (a)"
    server, engine, base = start_server("serve-spec", {**SPEC_PARAMS, "config": at_depth("llama2-7b", SPEC_LAYERS)},
                                        model=llama2_7b_at(SPEC_LAYERS))
    if not (engine.spec and not engine.spec_draft and engine.paged and engine.ec.spec_k == 3
            and engine.ec.max_batch == 24 and engine.ec.max_seq_len == 1024 and engine.cache["k"].dtype == torch.int8
            and isinstance(engine.params.layers[0].w_gate, Q4Tensor)):
        fail(f"{label}: the server is not the throughput example's (int4, int8 pages, B=24, lookup k=3)")
    try:
        tok = ByteTokenizer()
        ids = [tok.encode(text) for text, *_ in SPEC_PROMPTS]
        plain = plain_twin(engine, ids, SPEC_PROMPTS, f"{label} plain", card)
        prime_spec_graphs(engine)  # the server's engine is idle: nothing else launches meanwhile
        requests = tee_requests(engine)
        zero_counts(engine, int4_counters().values())
        results, wall = run_concurrent(base, SPEC_PROMPTS)
        wait_idle(engine)
        launches = spec_launches(engine)
        stats = dict(engine.stats)
        del engine.submit
        check_usage(SPEC_PROMPTS, results)
        by_prompt = {tuple(r.prompt_tokens): r for r in requests}
        reqs = [by_prompt[tuple(p)] for p in ids]
        check_spec_launches(engine, stats, launches, label)
        report = spec_report(engine, stats, reqs, plain, launches, label, card, profile_steps)
        if stats["spec_accepted"] <= 0:
            fail(f"{label}: no proposal accepted")
        report["recording_syncs"] = recording_sync_check(engine, ids, label)
    finally:
        server.stop()
    report["wall_s"] = wall
    return report, engine.params, engine.cfg


# The host-side recording of the engine (journeys, the step timeline, the
# SLO sketches and exemplars), by the functions that do it.
RECORDING_FUNCS = {"record", "record_once", "breach", "record_iteration", "_journey_end", "_observe_latency",
                   "snapshot"}


def recording_sync_check(engine, ids, label: str, iterations: int = 32) -> dict:
    """The running engine (serve-surface's params) serves 24 greedy requests
    under torch.cuda.set_sync_debug_mode("warn") for at least `iterations`
    replayed iterations: no warned host sync comes from a frame under
    observability/ or inside a journey, timeline or SLO recording call (the
    engine's own reads, the drain's and the first token's, may warn)."""
    import threading as _threading
    import warnings

    import torch

    from substratus_tpu_torch.serve.engine import Request

    seen = {"warnings": 0, "offending": []}
    lock = _threading.Lock()

    def hook(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        bad = [f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in stack
               if "/observability/" in f.filename or f.name in RECORDING_FUNCS]
        with lock:
            seen["warnings"] += 1
            if bad:
                seen["offending"].append((str(message)[:120], bad))

    replays0 = engine.stats["graph_replays"]
    iters0 = engine.timeline.bubble_totals()["iterations"]
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            reqs = [engine.submit(Request(list(ids[i % len(ids)]), max_tokens=48, temperature=0.0))
                    for i in range(engine.ec.max_batch)]
            for req in reqs:
                while req.out.get(timeout=600) is not None:
                    pass
            wait_idle(engine)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    replays = engine.stats["graph_replays"] - replays0
    iters = engine.timeline.bubble_totals()["iterations"] - iters0
    recs = engine.timeline.records()[-iters:] if iters else []
    timing = {key: {"median_ms": 1e3 * statistics.median(r[key] for r in recs),
                    "max_ms": 1e3 * max(r[key] for r in recs)} for key in ("wall_s", "dispatch_s", "drain_s")} \
        if recs else {}
    if replays < iterations or iters < iterations:
        fail(f"{label} sync check: {replays} replays over {iters} recorded iterations, want {iterations}")
    if seen["offending"]:
        fail(f"{label} sync check: host syncs from the recording: {seen['offending'][:4]}")
    print(f"{label}: {len(reqs)} requests, {iters} recorded iterations ({replays} graph replays) under sync debug "
          f"mode warn: {seen['warnings']} warned syncs, none from observability/ or a recording call; the timeline's "
          f"records of them (ms): {timing}", flush=True)
    return {"iterations": iters, "replays": replays, "warned_syncs": seen["warnings"], "timeline_ms": timing}


def check_spec_launches(engine, stats, launches, label: str) -> None:
    """Every forward's projections and lm_head through the int4 matmul once
    (prefills, chunks, every round's verify); each verify graph's by M =
    B x width; on the dense cache the cached flash kernel in every round
    wider than one token and the fused decode in the others, n_layers a
    forward."""
    from substratus_tpu_torch.ops.quant4 import WGMMA_MIN_M

    L, B = engine.cfg.n_layers, engine.ec.max_batch
    total, per_graph = launches["total"], launches["per_graph"]
    runs = {w: stats[f"rounds_w{w}"] for w in range(1, engine.ec.spec_k + 2) if stats[f"rounds_w{w}"]}
    if any(stats.get(f"replays_verify{w}", 0) != n for w, n in runs.items()) or stats["graph_warmups"] or \
            stats["graph_replays"] != stats["decode_steps"]:
        fail(f"{label}: every round must replay its width's graph, captured before the run: {stats}")
    forwards = stats["prefills"] + stats["prefill_chunks"] + sum(runs.values())
    q4 = total["q4_matmul_decode"] + total["q4_matmul_wgmma"] + total["q4_matmul"]
    want = {}
    for w, n in runs.items():
        design = "q4_matmul_wgmma" if B * w > WGMMA_MIN_M else "q4_matmul_decode"
        want[f"verify{w}"] = {design: (7 * L + 1) * n}
        if not engine.paged:
            want[f"verify{w}"]["flash_cached_int8" if w > 1 else "fused_decode_split"] = L * n
    got = {key: v for key, v in per_graph.items() if key.startswith("verify")}
    if q4 != (7 * L + 1) * forwards or total["q4_matmul"] or got != want or not total["q4_matmul_decode"] \
            or not total["q4_matmul_wgmma"]:
        fail(f"{label}: launches {launches} against {(7 * L + 1) * forwards} int4 matmuls and by graph {want}")
    if not engine.paged and (total["flash_cached_int8"] != sum(v.get("flash_cached_int8", 0) for v in want.values())
                             or not total["flash_cached_int8"] or not total["fused_decode_split"]):
        fail(f"{label}: the cached flash kernel must run every wide round's attention: {launches}")
    print(f"{label}: {forwards} forwards ({stats['prefills']} prefills, {stats['prefill_chunks']} chunks, "
          f"{sum(runs.values())} rounds) of {(7 * L + 1)} int4 matmuls each; by graph {got}",
          flush=True)


def spec_dense_leg(card: str, params, cfg, profile_steps: bool) -> dict:
    """(b) The dense stack (JAX's test_all_decode_levers_stack_dense_fused_
    int4_lookup at full width): leg (a)'s weights and knobs on the dense
    cache with the fused decode: the cached flash kernel runs every wide
    round over the int8 cache. The spec graphs are also held token for
    token against the eager synchronous spec round (eager_check)."""
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    label = "serve-spec (b)"
    tok = ByteTokenizer()
    ec = EngineConfig(max_batch=24, max_seq_len=1024, max_prefill_len=512, kv_cache_dtype="int8", kv_layout="dense",
                      spec_k=3, eos_token_id=tok.eos_id)
    engine = Engine(cfg.replace(decode_attn_impl="fused"), params, ec)
    ids = [tok.encode(text) for text, *_ in SPEC_PROMPTS]
    plain = plain_twin(engine, ids, SPEC_PROMPTS, f"{label} plain", card)
    warm_by_hand(engine, tok.encode(_repeat_text(99, 200)))
    prime_spec_graphs(engine)
    zero_counts(engine, int4_counters().values())
    reqs, wall = serve_all(engine, ids, SPEC_PROMPTS)
    launches = spec_launches(engine)
    stats = dict(engine.stats)
    check_spec_launches(engine, stats, launches, label)
    report = spec_report(engine, stats, reqs, plain, launches, label, card, profile_steps)
    if stats["spec_accepted"] <= 0:
        fail(f"{label}: no proposal accepted")
    report["eager"] = eager_spec_check(engine, reqs, label)
    report["wall_s"] = wall
    return report


def eager_spec_check(engine, reqs, label: str) -> dict:
    """A spec run's requests again through the eager round
    (decode_graph=False) with the engine's knobs, submitted as that run's
    were: overlapped, whose greedy tokens must be the graphs' token for
    token (the same schedule, so the same kernels at the same shapes);
    then synchronous (overlap=false), whose lookup history lags no round,
    so its proposals and verify widths may differ: each greedy request is
    identical or first differs at a near-tie."""
    import dataclasses

    from substratus_tpu_torch.serve.engine import Engine

    prompts = [r.prompt_tokens for r in reqs]
    specs = [(None, r.max_tokens, r.temperature, False) for r in reqs]
    out = {}
    for overlap in (True, False):
        eager = Engine(engine.cfg, engine.params, dataclasses.replace(engine.ec, overlap=overlap),
                       device=engine.device, model=engine.model, decode_graph=False,
                       draft=(engine.draft_cfg, engine.draft_params) if engine.spec_draft else None)
        name = "eager overlapped" if overlap else "eager synchronous"
        ereqs, wall = serve_all(eager, prompts, specs)
        if eager.decode_graph or eager.stats["graph_replays"]:
            fail(f"{label}: the {name} engine replayed a graph")
        summary = run_summary(eager, dict(eager.stats), ereqs, f"{label} {name}", card_line())
        if overlap:
            for req, twin in zip(reqs, ereqs):
                if req.temperature == 0.0 and (req.out.tokens, req.finish_reason) != (twin.out.tokens,
                                                                                       twin.finish_reason):
                    fail(f"{label}: a greedy request's tokens differ between the graphs and the eager round: "
                         f"{req.out.tokens} against {twin.out.tokens}")
            same = {"identical": sum(r.temperature == 0.0 for r in reqs)}
            print(f"{label}: all {same['identical']} greedy requests token for token the eager overlapped round's",
                  flush=True)
        else:
            same = against_plain(engine, reqs, ereqs, label, f"the {name} round's")
        out[name] = dict(summary, against=same, wall_s=wall)
        del eager
        gc.collect()
    return out


def spec_draft_leg(card: str, profile_steps: bool) -> dict:
    """(c) A draft model: llama2-7b bf16 on the paged pool, spec_k 4, B=8,
    serve's five prompts and three repetitive ones. First tinyllama-1.1b
    from seed 1, written by tools/ckpt_writer.py and served as
    draft_model through serve.main (it disagrees: rounds are rejected and
    the adaptive policy degrades the streams); then the target as its own
    draft (JAX's test_engine_speculation_exact_and_accelerated: every
    proposal accepted)."""
    import tempfile

    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve.engine import Engine
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_draft_"))
    out = {}
    try:
        dcfg = llama.CONFIGS["tinyllama-1.1b"]
        source = llama.init_params(dcfg, seed=1, device="cuda")
        disk_room(tmp, sum(t.numel() * t.element_size() for t in source.state_dict().values()), "serve-spec draft")
        written = write_hf(str(tmp / "tinyllama-1.1b"), source)
        del source
        params_json = {"config": at_depth("llama2-7b", SPEC_LAYERS), "max_batch": 8, "max_seq_len": 1024,
                       "max_prefill_len": 512, "spec_k": 4, "draft_model": str(tmp / "tinyllama-1.1b")}
        label = "serve-spec (c) tinyllama draft"
        server, engine, base = start_server("serve-spec-draft", params_json, model=llama2_7b_at(SPEC_LAYERS))
        d = engine.draft_cfg if engine.spec_draft else None
        if d is None or not engine.paged or any(getattr(d, f) != getattr(dcfg, f) for f in (
                "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim", "vocab_size")):
            fail(f"{label}: the server does not propose with tinyllama-1.1b on the paged pool: {d}")
        try:
            tok = ByteTokenizer()
            ids = [tok.encode(text) for text, *_ in DRAFT_PROMPTS]
            plain = plain_twin(engine, ids, DRAFT_PROMPTS, "serve-spec (c) plain", card)
            prime_spec_graphs(engine)
            requests = tee_requests(engine)
            zero_counts(engine, int4_counters().values())
            results, wall = run_concurrent(base, DRAFT_PROMPTS)
            wait_idle(engine)
            launches = spec_launches(engine)
            stats = dict(engine.stats)
            del engine.submit
            check_usage(DRAFT_PROMPTS, results)
            by_prompt = {tuple(r.prompt_tokens): r for r in requests}
            reqs = [by_prompt[tuple(p)] for p in ids]
            out["tinyllama"] = spec_report(engine, stats, reqs, plain, launches, label, card, profile_steps)
            out["tinyllama"].update(wall_s=wall, draft_bytes_written=written["bytes"])
        finally:
            server.stop()
        label = "serve-spec (c) self-draft"
        selfd = Engine(engine.cfg, engine.params, engine.ec, draft=(engine.cfg, engine.params))
        del engine, server
        gc.collect()
        torch.cuda.empty_cache()
        warm_by_hand(selfd, tok.encode(_repeat_text(99, 200)))
        prime_spec_graphs(selfd)
        zero_counts(selfd, int4_counters().values())
        reqs, wall = serve_all(selfd, ids, DRAFT_PROMPTS)
        launches = spec_launches(selfd)
        stats = dict(selfd.stats)
        out["self"] = spec_report(selfd, stats, reqs, plain, launches, label, card, profile_steps)
        out["self"]["wall_s"] = wall
        if stats["spec_accepted"] <= 0:
            fail(f"{label}: the target as its own draft had no proposal accepted")
        del selfd
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def serve_spec_phase(card: str, profile_steps: bool = False) -> dict:
    """Speculative decoding at llama2-7b's full width in three legs, each
    against a plain engine on the same requests and weights: (a) the
    throughput example through serve.main (prompt lookup on int8 pages),
    (b) the same weights on the dense cache with the fused decode (the
    cached flash kernel on every wide round), (c) a draft model."""
    import torch

    gc.collect()  # the earlier phases' servers and caches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {}
    out["lookup"], params, cfg = spec_lookup_leg(card, profile_steps)
    gc.collect()
    torch.cuda.empty_cache()
    out["dense"] = spec_dense_leg(card, params, cfg, profile_steps)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["draft"] = spec_draft_leg(card, profile_steps)
    # The legs' launches of each design, for the kernels line.
    out["launches"] = {name: sum(leg["launches"]["total"][name] for leg in (out["lookup"], out["dense"]))
                       for name in SPEC_DESIGNS}
    out["seconds"] = time.perf_counter() - t0
    print(f"serve-spec: {out['seconds']:.1f} s; launches of legs (a) and (b) by design {out['launches']}", flush=True)
    return out


# --- checkpoints: serve.main and train.main on loaded weights -------------------

CKPT_TRAIN_STEPS = 2
# serve-ckpt's depth: llama2-7b's width at 4 of its 32 layers, cut so that
# the default run stays within its time limit (16 once serve-disagg joined
# it, 8 once serve-gang did, 4 to keep it well inside; every leg and check
# as at full depth).
CKPT_LAYERS = 4
CKPT_MODEL = (f"llama2-7b at {CKPT_LAYERS} layers", (4096, CKPT_LAYERS, 32, 32, 32000))


def disk_room(path: Path, need: int, label: str) -> int:
    """Free bytes where a checkpoint is about to be written; too few fail
    the run (the phase is never skipped)."""
    free = shutil.disk_usage(path).free
    print(f"{label}: {free} bytes free in {path} before writing about {need}", flush=True)
    if free < need * 1.1:
        fail(f"{label}: {free} bytes free, the checkpoint needs about {need}")
    return free


def timed_loads():
    """Wrap serve.main's load_checkpoint so that each call's seconds
    (synchronized) land in the returned list; the wrapper stays until
    `restore()`."""
    import torch

    from substratus_tpu_torch.serve import main as serve_main

    seconds, load = [], serve_main.load_checkpoint

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = load(*args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    serve_main.load_checkpoint = timed
    return seconds, lambda: setattr(serve_main, "load_checkpoint", load)


def same_state(a, b, label: str) -> int:
    """Fail unless two modules' state dicts are equal tensor for tensor, bit
    for bit; returns the bytes compared."""
    import torch

    sa, sb = a.state_dict(), b.state_dict()
    if set(sa) != set(sb):
        fail(f"{label}: the loaded model has other tensors: {sorted(set(sa) ^ set(sb))[:8]}")
    bad = [n for n, t in sa.items() if torch.is_tensor(t) and (t.dtype != sb[n].dtype or t.shape != sb[n].shape
                                                               or not torch.equal(t, sb[n]))]
    if bad:
        fail(f"{label}: {len(bad)} tensors differ from the source, first {bad[:4]}")
    return sum(t.numel() * t.element_size() for t in sa.values() if torch.is_tensor(t))


def ckpt_hf_part(card: str, tmp: Path) -> dict:
    """llama2-7b (seed 0, bf16) written as an HF safetensors directory,
    served through serve.main --model with serve's knobs: the loaded
    weights bit for bit the source's, the served greedy tokens those of an
    in-process engine on the source weights, the reference check."""
    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    cfg = llama.CONFIGS["llama2-7b"].replace(n_layers=CKPT_LAYERS)
    source = llama.init_params(cfg, seed=0, device="cuda")
    nbytes = sum(t.numel() * t.element_size() for t in source.state_dict().values())
    free = disk_room(tmp, nbytes, "serve-ckpt safetensors")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = write_hf(str(tmp / "hf"), source)
    write_s = time.perf_counter() - t0
    print(f"serve-ckpt: llama2-7b written as {len(written['files'])} safetensors shards, {written['bytes']} bytes in "
          f"{write_s:.1f} s", flush=True)
    loads, restore = timed_loads()
    try:
        server, engine, base = start_server("serve-ckpt-hf", {k: v for k, v in SERVE_PARAMS.items() if k != "config"},
                                            ["--model", str(tmp / "hf")], model=CKPT_MODEL)
    finally:
        restore()
    requests = tee_requests(engine)
    try:
        compared = same_state(engine.params, source, "serve-ckpt safetensors")
        zero_counts(engine, (flash_attention, decode_attention))
        results, wall = run_concurrent(base, PROMPTS)
        wait_idle(engine)
        launches = {"flash_fwd": launched(engine, flash_attention),
                    "flash_fwd_wgmma": launched(engine, flash_attention, "launches_wgmma"),
                    "decode_attn": launched(engine, decode_attention),
                    "decode_attn_split": launched(engine, decode_attention, "launches_split")}
        stats = dict(engine.stats)
        del engine.submit
        same = eager_check(engine, requests, "serve-ckpt safetensors", params=source)
        reference = reference_check(engine)
    finally:
        server.stop()
    generated = check_usage(PROMPTS, results)
    L = cfg.n_layers
    if (launches["flash_fwd"] != L * stats["prefills"] or launches["decode_attn"] != L * stats["decode_steps"]
            or launches["flash_fwd_wgmma"] != launches["flash_fwd"] or not launches["decode_attn"]
            or launches["decode_attn_split"] != launches["decode_attn"] or not launches["flash_fwd"]):
        fail(f"serve-ckpt safetensors: launches {launches} against {L} x {stats['prefills']} prefills and "
             f"{L} x {stats['decode_steps']} decode steps")
    load_s = loads[0]
    print(f"serve-ckpt safetensors [{card}]: serve.main --model loaded {written['bytes']} bytes in {load_s:.2f} s "
          f"({written['bytes'] / load_s / 1e9:.2f} GB/s); {compared} bytes bit for bit the source's; "
          f"{len(PROMPTS)} requests, {generated} tokens in {wall:.2f} s; launches {launches}", flush=True)
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    loader = ckpt_load_main_part(card, tmp, source, requests, written["bytes"])
    del source
    gc.collect()
    torch.cuda.empty_cache()
    return {"bytes": written["bytes"], "shards": len(written["files"]), "write_s": write_s, "load_s": load_s,
            "load_gb_per_s": written["bytes"] / load_s / 1e9, "free_bytes_before": free, "launches": launches,
            "stats": stats, "same_as_source": same, "reference": reference, "load_main": loader}


# The trace the loader's child joins (TRACEPARENT).
LOADER_TRACE = ("10ad" * 8, "5a" * 8)


def run_load_main(out: Path, args, label: str, params=None, env_extra=None, child: bool = True) -> dict:
    """The loader entry point into `out`: python -m
    substratus_tpu_torch.load.main as a child process (a non-zero exit
    fails), or its run() in this process; its wall seconds, the load's
    seconds (the weights on the card) and the whole run's as it prints
    them, and the artifact's bytes."""
    import os
    import re

    from substratus_tpu_torch.load import main as load_main

    params_path = out.parent / f"{out.name}_params.json"
    params_path.write_text(json.dumps(params or {}))
    argv = ["--out", str(out), "--params", str(params_path), *args]
    env = {**os.environ, **(env_extra or {}),
           "PYTHONPATH": str(Path(__file__).resolve().parent) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    if child:
        proc = subprocess.run([sys.executable, "-m", "substratus_tpu_torch.load.main", *argv],
                              cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"{label}: load.main exited {proc.returncode}: {proc.stdout[-2000:]}")
        m = re.search(r"loaded in ([0-9.]+) s, ([0-9.]+) s in all", proc.stdout)
        if m is None:
            fail(f"{label}: load.main printed no timing: {proc.stdout[-1000:]}")
        load_s, run_s = float(m.group(1)), float(m.group(2))
    else:
        res = load_main.run(argv)
        load_s, run_s = res["load_seconds"], res["seconds"]
        del res
    wall = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in out.iterdir() if f.is_file())
    return {"wall_s": wall, "load_s": load_s, "run_s": run_s, "artifact_bytes": nbytes}


def ckpt_load_main_part(card: str, tmp: Path, source, hf_requests, hf_bytes: int) -> dict:
    """The loader entry point on the safetensors directory: load.main under
    TRACEPARENT writes the port's artifact (its load and wall seconds, GB/s,
    bytes; the free bytes printed first: the directory and the artifact
    stand on disk together), which serve.main --model serves with serve's
    knobs, its state bit for bit the source's and its greedy tokens those
    the directory's server served; trace.jsonl holds load.run under the
    trace. Then with quantize int8: the artifact's int8 weights bit for bit
    the port's in-process quantize_weights of the same weights, one greedy
    request by the reference rule."""
    import copy

    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention
    from substratus_tpu_torch.train.checkpoints import load_artifact

    label = "serve-ckpt load.main"
    out = {}
    art = tmp / "artifact"
    free = disk_room(tmp, hf_bytes, label)
    run = run_load_main(art, ["--name", str(tmp / "hf")], label,
                        env_extra={"TRACEPARENT": traceparent(*LOADER_TRACE)})
    spans = [json.loads(ln) for ln in (art / "trace.jsonl").read_text().splitlines()]
    if not any(s["name"] == "load.run" and (s["trace_id"], s["parent_id"]) == LOADER_TRACE for s in spans):
        fail(f"{label}: trace.jsonl holds {spans}")
    print(f"{label} [{card}]: the safetensors directory ({hf_bytes} bytes; {free} bytes free before) to an artifact of "
          f"{run['artifact_bytes']} bytes: the weights on the card in {run['load_s']:.2f} s "
          f"({hf_bytes / run['load_s'] / 1e9:.2f} GB/s), {run['run_s']:.2f} s with the write, {run['wall_s']:.1f} s as a "
          f"process; load.run in trace.jsonl under TRACEPARENT's trace", flush=True)
    loads, restore = timed_loads()
    try:
        server, engine, base = start_server("serve-ckpt-artifact", {k: v for k, v in SERVE_PARAMS.items()
                                                                     if k != "config"}, ["--model", str(art)],
                                            model=CKPT_MODEL)
    finally:
        restore()
    requests = tee_requests(engine)
    try:
        compared = same_state(engine.params, source, label)
        zero_counts(engine, (flash_attention, decode_attention))
        results, wall = run_concurrent(base, PROMPTS)
        wait_idle(engine)
        launches = {"flash_fwd": launched(engine, flash_attention),
                    "flash_fwd_wgmma": launched(engine, flash_attention, "launches_wgmma"),
                    "decode_attn": launched(engine, decode_attention),
                    "decode_attn_split": launched(engine, decode_attention, "launches_split")}
        stats = dict(engine.stats)
        del engine.submit
    finally:
        server.stop()
    check_usage(PROMPTS, results)
    greedy = lambda reqs: {tuple(r.prompt_tokens): r.out.tokens for r in reqs if r.temperature == 0.0}  # noqa: E731
    want, got = greedy(hf_requests), greedy(requests)
    if got != want or len(got) != sum(1 for _, _, temp, _ in PROMPTS if temp == 0.0):
        fail(f"{label}: the artifact's server served other greedy tokens than the directory's")
    L = engine.cfg.n_layers
    if launches["flash_fwd"] != L * stats["prefills"] or launches["decode_attn"] != L * stats["decode_steps"] \
            or not launches["decode_attn_split"] or launches["flash_fwd_wgmma"] != launches["flash_fwd"]:
        fail(f"{label}: launches {launches} against {stats}")
    print(f"{label} [{card}]: serve.main --model <the artifact> loaded it in {loads[0]:.2f} s "
          f"({run['artifact_bytes'] / loads[0] / 1e9:.2f} GB/s); {compared} bytes bit for bit the source's; "
          f"{len(got)} greedy requests token for token the directory's server's; launches {launches}", flush=True)
    out["bf16"] = {**run, "hf_gb_per_s": hf_bytes / run["load_s"] / 1e9,
                   "free_bytes_before": free, "serve_load_s": loads[0], "launches": launches, "stats": stats}
    del engine, server
    shutil.rmtree(art)
    gc.collect()
    torch.cuda.empty_cache()

    art8 = tmp / "artifact_int8"
    run8 = run_load_main(art8, ["--name", str(tmp / "hf")], f"{label} int8", params={"quantize": "int8"},
                         child=False)
    quantized = llama.quantize_weights(copy.deepcopy(source), "int8")
    _, loaded = load_artifact(str(art8))
    compared8 = same_state(loaded, quantized, f"{label} int8")
    n_int8 = sum(1 for n, t in loaded.state_dict().items() if t.dtype == torch.int8)
    del loaded, quantized
    gc.collect()
    torch.cuda.empty_cache()
    server, engine, base = start_server("serve-ckpt-artifact-int8", {k: v for k, v in SERVE_PARAMS.items()
                                                                      if k != "config"}, ["--model", str(art8)],
                                        model=CKPT_MODEL)
    try:
        if type(engine.params.layers[0].wq).__name__ != "QTensor":
            fail(f"{label} int8: the served weights are {type(engine.params.layers[0].wq).__name__}")
        reference = reference_check(engine)
    finally:
        server.stop()
    print(f"{label} int8 [{card}]: quantize int8 wrote {run8['artifact_bytes']} bytes in {run8['run_s']:.2f} s; "
          f"{compared8} bytes ({n_int8} int8 tensors and their scales) bit for bit the in-process quantize_weights; "
          f"served by the reference rule", flush=True)
    out["int8"] = {**run8, "reference": reference}
    del engine, server
    shutil.rmtree(art8)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ckpt_qlora_part(card: str, tmp: Path) -> dict:
    """train.main --model on the safetensors directory with quantize int8
    (QLoRA) and the train phase's LoRA params, for 2 steps."""
    import numpy as np
    import torch

    from substratus_tpu_torch.train import main as train_main

    (tmp / "data").mkdir(exist_ok=True)
    np.save(tmp / "data" / "corpus.npy", np.random.default_rng(0).integers(0, 32000, 100_000, dtype=np.int32))
    params = {k: v for k, v in TRAIN_PARAMS.items() if k != "config"}
    (tmp / "qlora.json").write_text(json.dumps(dict(params, steps=CKPT_TRAIN_STEPS, quantize="int8")))
    disk_room(tmp, 8 * 10**9, "serve-ckpt QLoRA artifact")
    _zero_train_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        res = train_main.run(["--model", str(tmp / "hf"), "--data", str(tmp / "data"), "--out", str(tmp / "qlora"),
                              "--params", str(tmp / "qlora.json")])
        launches = _train_launches()
        peak = torch.cuda.max_memory_allocated()
        n = len(res["losses"])
        quantized = type(res["trainer"].params.layers[0].wk).__name__
        if quantized != "QTensor" or res["trainer"].lora is None:
            fail(f"serve-ckpt QLoRA: the base is {quantized}, adapters {res['trainer'].lora is not None}")
        L = CKPT_LAYERS  # with remat: 2 x L forward launches a step, L of each backward kernel
        if launches != {"flash_fwd": 2 * L * n, "flash_fwd_all": 2 * L * n, "flash_bwd_dq": L * n,
                        "flash_bwd_dq_all": L * n, "flash_bwd_dkv": L * n, "flash_bwd_dkv_all": L * n}:
            fail(f"serve-ckpt QLoRA: launches {launches} over {n} steps")
        if n != CKPT_TRAIN_STEPS or not all(np.isfinite(res["losses"])):
            fail(f"serve-ckpt QLoRA: losses {res['losses']}")
        out = {"losses": res["losses"], "step_s": res["step_seconds"], "peak_bytes": peak, "launches": launches,
               "artifact_s": res["artifact_seconds"]}
    finally:
        shutil.rmtree(tmp / "qlora", ignore_errors=True)
    print(f"serve-ckpt QLoRA [{card}]: train.main --model <safetensors dir> with quantize int8, LoRA r16 on wq/wv, "
          f"batch 8 x 1024, remat: losses {out['losses']}, steps {out['step_s']} s, peak {peak / 2**30:.1f} GiB; "
          f"backward launches {launches} (wgmma design: flash_bwd_dq, flash_bwd_dkv)", flush=True)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gguf_prompts(tok) -> list:
    """serve-int4's prompts under the embedded vocabulary: serve's five and
    one greedy long prompt grown until it holds at least 1500 tokens."""
    n = 1499
    while len(tok.encode(text := _long_text(n, 5))) < 1500:
        n += 500
    return PROMPTS + [(text, 32, 0.0, True)]


def ckpt_gguf_part(card: str, tmp: Path) -> dict:
    """The same weights written as a Q4_0 GGUF (Q8_0 embedding and output,
    F32 norms) with a 32000-piece SPM vocabulary, served through
    serve.main --model with serve-int4's knobs (int4 weights requantized
    from the loaded ones, int8 cache, fused decode): the loaded weights bit
    for bit the writer's dequantization, the served greedy tokens those of
    an in-process engine on those weights, every prompt through the
    embedded tokenizer and back, the reference check."""
    import torch

    from substratus_tpu_torch.load.gguf import load_gguf, tokenizer_from_gguf
    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.tools.ckpt_writer import spm_vocab, write_gguf

    cfg = llama.CONFIGS["llama2-7b"].replace(n_layers=CKPT_LAYERS)
    source = llama.init_params(cfg, seed=0, device="cuda")
    vocab = spm_vocab(cfg.vocab_size, 0, tuple(text for text, *_ in PROMPTS) + (_long_text(20000, 5),))
    path = tmp / "llama2-7b-q4_0.gguf"
    free = disk_room(tmp, 4_100_000_000 * CKPT_LAYERS // 32, "serve-ckpt gguf")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    expected = write_gguf(str(path), source, vocab)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    size = path.stat().st_size
    del source
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, loaded = load_gguf(str(path), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    compared = same_state(loaded, expected, "serve-ckpt gguf")
    del expected
    torch.cuda.empty_cache()
    gguf_art = tmp / "gguf_artifact"
    disk_room(tmp, 2 * compared, "serve-ckpt gguf load.main")
    run = run_load_main(gguf_art, ["--name", str(path)], "serve-ckpt gguf load.main", child=False)
    state = torch.load(gguf_art / "params.pt", map_location="cuda", mmap=True, weights_only=True)
    want = loaded.state_dict()
    if set(state) != set(want) or any(not torch.equal(v, want[k]) or v.dtype != want[k].dtype
                                      for k, v in state.items()):
        fail("serve-ckpt gguf load.main: the artifact's state is not load_gguf's")
    sidecar = (gguf_art / "tokenizer.gguf").stat().st_size if (gguf_art / "tokenizer.gguf").is_file() else 0
    if not sidecar:
        fail("serve-ckpt gguf load.main: no tokenizer.gguf beside the artifact")
    print(f"serve-ckpt gguf load.main: the Q4_0 file to an artifact of {run['artifact_bytes']} bytes in "
          f"{run['run_s']:.2f} s (the weights dequantized on the card in {run['load_s']:.2f} s); its state bit for bit "
          f"load_gguf's; tokenizer.gguf {sidecar} bytes beside it", flush=True)
    del state
    shutil.rmtree(gguf_art)
    torch.cuda.empty_cache()
    print(f"serve-ckpt gguf: {size} bytes written in {write_s:.1f} s; load_gguf {load_s:.2f} s "
          f"({size / load_s / 1e9:.2f} GB/s of file), {compared} bytes bit for bit the writer's dequantization",
          flush=True)
    tok = tokenizer_from_gguf(str(path))
    prompts = gguf_prompts(tok)
    for text, *_ in prompts:
        if tok.decode(tok.encode(text)) != text:
            fail(f"serve-ckpt gguf: {text[:30]!r} does not decode back from its ids")
    n_bytes, n_tokens = (sum(len(t.encode()) for t, *_ in prompts), sum(len(tok.encode(t)) - 1 for t, *_ in prompts))
    llama.quantize_weights(loaded, "int4")  # as serve.main quantizes what it loads
    loads, restore = timed_loads()
    try:
        params = {k: v for k, v in INT4_PARAMS.items() if k != "config"}
        server, engine, base = start_server("serve-ckpt-gguf", params, ["--model", str(path)], model=CKPT_MODEL)
    finally:
        restore()
    counters = int4_counters()
    requests = tee_requests(engine)
    try:
        same_state(engine.params, loaded, "serve-ckpt gguf int4")
        zero_counts(engine, counters.values())
        results, wall = run_concurrent(base, prompts)
        wait_idle(engine)
        launches = int4_launches(engine, counters)
        stats = dict(engine.stats)
        del engine.submit
        same = eager_check(engine, requests, "serve-ckpt gguf", params=loaded)
        reference = long_reference_check(engine, [r for r in requests if r.temperature == 0.0], "serve-ckpt gguf")
    finally:
        server.stop()
    if server.state.tokenizer.vocab_size != cfg.vocab_size:
        fail(f"serve-ckpt gguf: served with a tokenizer of {server.state.tokenizer.vocab_size} ids")
    generated = check_usage(prompts, results, tok.encode)
    check_int4_launches(engine, stats, launches, [len(tok.encode(t)) for t, *_ in prompts], "serve-ckpt gguf")
    print(f"serve-ckpt gguf [{card}]: serve.main --model loaded and requantized to int4 in {loads[0]:.2f} s; "
          f"{len(prompts)} requests of {[len(tok.encode(t)) for t, *_ in prompts]} tokens "
          f"({n_tokens / n_bytes:.3f} tokens per byte through the embedded vocabulary), {generated} tokens in "
          f"{wall:.2f} s; launches {launches}", flush=True)
    del engine, server, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return {"bytes": size, "write_s": write_s, "load_gguf_s": load_s, "load_gb_per_s": size / load_s / 1e9,
            "load_main": run, "tokenizer_sidecar_bytes": sidecar,
            "serve_load_s": loads[0], "free_bytes_before": free, "tokens_per_byte": n_tokens / n_bytes,
            "launches": launches, "stats": stats, "same_as_source": same, "reference": reference}


def serve_ckpt_phase(card: str) -> dict:
    """Checkpoints at llama2-7b's full width (CKPT_LAYERS deep), one on disk
    at a time: the safetensors directory (served, then the QLoRA base), then
    the GGUF file."""
    import tempfile

    import torch

    gc.collect()  # the earlier phases' servers and caches
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        out = {"safetensors": ckpt_hf_part(card, tmp)}
        out["qlora"] = ckpt_qlora_part(card, tmp)
        shutil.rmtree(tmp / "hf")
        out["gguf"] = ckpt_gguf_part(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# --- the serving surface: serve.main as a child process ---------------------------

# serve-spec's params (the throughput example: int4, int8 pages, B=24, lookup
# k=3) from a checkpoint, with a short queue (429 under a burst) and a grace.
SURFACE_PARAMS = {"quantize": "int4", "kv_cache_dtype": "int8", "max_batch": 24, "spec_k": 3, "max_queue": 4,
                  "drain_grace": 60}
# The keys of the JAX engine's load_snapshot() (substratus_tpu/serve/engine.py
# load_snapshot, without batch generation and adapters) and of its /loadz.
LOADZ_KEYS = ("queue_depth", "active_slots", "max_slots", "kv_free_frac", "max_queue", "role", "transfer_queue_depth",
              "overlap", "weights_version", "prefill_tokens", "prefix_hit_tokens", "load_seq", "load_ts", "slo", "spec",
              "model", "draining")
SURFACE_CHAT = [{"role": "system", "content": "You answer about caches."},
                {"role": "user", "content": "How do the pages of a long prompt decode?"}]
SURFACE_PROMPT = "the cache of a long prompt runs in chunks through the"
BURST = 36


def scrape(base: str) -> dict:
    """/metrics parsed: {"types": {family: type}, "samples": {name{labels}: value}}; fails on a line that is
    neither a comment nor a sample."""
    status, headers, text = http(base, "/metrics")
    if status != 200 or headers.get("Content-Type") != "text/plain; version=0.0.4; charset=utf-8":
        fail(f"serve-surface: /metrics -> {status} {headers.get('Content-Type')}")
    types, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types[name] = kind
        elif line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            if not key:
                fail(f"serve-surface: /metrics line {line!r} does not parse")
            samples[key] = float(value)
    return {"types": types, "samples": samples}


def surface_forwards(metrics: dict) -> int:
    """The child engine's forwards so far: prefills, prefill chunks, rounds,
    and each verify graph's warm-up at its capture (one a width used)."""
    s = metrics["samples"]
    verify_captures = sum(1 for k, v in s.items() if k.startswith("substratus_serve_replays_verify") and v > 0)
    return verify_captures + sum(int(s.get(f"substratus_serve_{k}", 0))
                                 for k in ("prefills", "prefill_chunks", "decode_steps"))


def surface_launches(metrics: dict) -> dict:
    """The child's kernel counters from substratus_serve_kernel_launches."""
    prefix = 'substratus_serve_kernel_launches{counter="'
    return {k[len(prefix):-2]: int(v) for k, v in metrics["samples"].items() if k.startswith(prefix)}


class SurfaceChild:
    """serve.main in a child process (a real SIGTERM ends it), its output in
    OUT_DIR/serve_surface_child.log; the port it printed."""

    def __init__(self, model: Path, params: dict, env: dict):
        OUT_DIR.mkdir(exist_ok=True)
        self.params_path = OUT_DIR / "chip_smoke_params_serve-surface.json"
        self.params_path.write_text(json.dumps(params))
        self.log = (OUT_DIR / "serve_surface_child.log").open("w")
        self.lines = []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", "substratus_tpu_torch.serve.main", "--model", str(model),
                                      "--params", str(self.params_path), "--host", "127.0.0.1", "--port", "0"],
                                     cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.serving = threading.Event()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.log.write(line)
            self.log.flush()
            self.lines.append(line)
            if line.startswith("serving "):
                self.serving.set()

    def wait_ready(self, timeout: float = 300) -> tuple:
        """(base URL, seconds from the start to GET / answering 200)."""
        if not self.serving.wait(timeout) or self.proc.poll() is not None:
            fail(f"serve-surface: the child did not start: {''.join(self.lines[-20:])}")
        line = next(ln for ln in self.lines if ln.startswith("serving "))
        base = f"http://127.0.0.1:{int(line.split('127.0.0.1:')[1].split()[0])}"
        while http(base, "/")[0] != 200:
            if self.proc.poll() is not None or time.perf_counter() - self.t0 > timeout:
                fail(f"serve-surface: the child never became ready: {''.join(self.lines[-20:])}")
            time.sleep(0.1)
        return base, time.perf_counter() - self.t0

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.reader.join(timeout=10)
        self.log.close()


def write_surface_checkpoints(tmp: Path) -> dict:
    """llama2-7b seed 0 and seed 1, and a 2-layer model of its width, as Q4_0
    GGUF files with a 32000-piece SPM vocabulary and a chat template."""
    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.tools.ckpt_writer import LLAMA2_CHAT_TEMPLATE, spm_vocab, write_gguf

    cfg = llama.CONFIGS["llama2-7b"]
    paths = {"n_layers": cfg.n_layers}
    texts = (SURFACE_PROMPT, _long_text(20000, 5)) + tuple(m["content"] for m in SURFACE_CHAT)
    vocab = spm_vocab(cfg.vocab_size, 0, texts, chat_template=LLAMA2_CHAT_TEMPLATE)
    for name, seed, c in (("seed0", 0, cfg), ("seed1", 1, cfg), ("two_layers", 0, cfg.replace(n_layers=2))):
        disk_room(tmp, 4_100_000_000 * c.n_layers // cfg.n_layers, f"serve-surface {name}")
        path = tmp / f"llama2-7b-{name}.gguf"
        t0 = time.perf_counter()
        model = llama.init_params(c, seed=seed, device="cuda")
        write_gguf(str(path), model, vocab)
        del model
        torch.cuda.empty_cache()
        print(f"serve-surface: {path.name} ({path.stat().st_size} bytes) written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        paths[name] = path
    return paths


def surface_contract(base: str, tok, label: str) -> dict:
    """Leg (a): chat held by the template, stop (whole and streamed), /loadz's
    keys, /metrics against the requests served, a burst into 429s, 504."""
    served = 0
    out = {}
    # Chat, whole and streamed: the prompt is the template's rendering.
    rendered = tok.apply_chat_template(SURFACE_CHAT)
    want_prompt = len(tok.encode_templated(rendered))
    body = {"messages": SURFACE_CHAT, "max_tokens": 24, "temperature": 0}
    status, _, text = http(base, "/v1/chat/completions", body)
    chat = json.loads(text) if status == 200 else fail(f"{label}: chat -> {status} {text}")
    status, _, text = http(base, "/v1/chat/completions", {**body, "stream": True,
                                                           "stream_options": {"include_usage": True}})
    pieces, finish, usage, done = sse_parse(text, chat=True)
    if chat["usage"]["prompt_tokens"] != want_prompt or (usage or {}).get("prompt_tokens") != want_prompt or not done:
        fail(f"{label}: chat prompt tokens {chat['usage']} / {usage}, the template renders {want_prompt}")
    # The rendering is longer than a page: the second request takes the first
    # one's page from the registry, so its chunk (and the int4 design by rows)
    # differs and bf16 near-ties may flip; each answer is held to its own usage.
    if len(pieces) != usage["completion_tokens"] + 1 or (finish == "length") != (usage["completion_tokens"] == 24) \
            or (chat["choices"][0]["finish_reason"] == "length") != (chat["usage"]["completion_tokens"] == 24):
        fail(f"{label}: chat finish/usage: {chat['choices'][0]['finish_reason']} {chat['usage']}; streamed {finish} "
             f"{usage} in {len(pieces)} chunks")
    served += 2
    # stop: a substring of an earlier greedy completion of the same prompt.
    body = {"prompt": SURFACE_PROMPT, "max_tokens": 48, "temperature": 0}
    status, _, text = http(base, "/v1/completions", body)
    full = json.loads(text)["choices"][0]["text"]
    words = full.split()
    if len(words) < 6:
        fail(f"{label}: the greedy completion {full!r} has too few words to cut")
    stop = " " + words[4]
    cut = full.find(stop)
    status, _, text = http(base, "/v1/completions", {**body, "stop": stop})
    got = json.loads(text)
    served += 2
    if (got["choices"][0]["text"] != full[:cut] or got["choices"][0]["finish_reason"] != "stop"
            or got["usage"]["completion_tokens"] >= 48):
        fail(f"{label}: stop {stop!r}: {got['choices'][0]} {got['usage']}, want {full[:cut]!r}")
    t0 = time.perf_counter()
    while json.loads(http(base, "/loadz")[2])["active_slots"] and time.perf_counter() - t0 < 5:
        time.sleep(0.05)
    if json.loads(http(base, "/loadz")[2])["active_slots"]:
        fail(f"{label}: the stopped request's slot is not free")
    status, _, text = http(base, "/v1/completions", {**body, "stop": [stop], "stream": True})
    pieces, finish, _, done = sse_parse(text)
    served += 1
    if "".join(pieces) != full[:cut] or finish != "stop" or not done or \
            any(stop in "".join(pieces[:n]) for n in range(len(pieces) + 1)):
        fail(f"{label}: the streamed stop sent {''.join(pieces)!r} ({finish}), want {full[:cut]!r}")
    out["stop"] = {"stop": stop, "cut_at_char": cut, "completion_tokens": got["usage"]["completion_tokens"]}
    # A burst past max_queue: at least 8 shed with Retry-After >= 1, the rest served whole.
    results = [None] * BURST

    def one(i):
        results[i] = http(base, "/v1/completions", {"prompt": f"{SURFACE_PROMPT} {i}", "max_tokens": 16,
                                                    "temperature": 0})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(BURST)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    burst_s = time.perf_counter() - t0
    shed = [r for r in results if r[0] == 429]
    admitted = [r for r in results if r[0] != 429]
    if len(shed) < 8 or any(int(r[1].get("Retry-After", 0)) < 1 for r in shed):
        fail(f"{label}: a burst of {BURST} got {len(shed)} answers of 429 (want >= 8 with Retry-After >= 1)")
    for status, _, text in admitted:
        if status != 200 or not 1 <= json.loads(text)["usage"]["completion_tokens"] <= 16:
            fail(f"{label}: an admitted request of the burst: {status} {text[:200]}")
    served += len(admitted)
    out["burst"] = {"requests": BURST, "shed_429": len(shed), "served": len(admitted), "seconds": burst_s}
    # An expired deadline: 504.
    status, _, text = http(base, "/v1/completions", {"prompt": "late"},
                           {"x-request-deadline": str(time.time() - 1)})
    if status != 504 or json.loads(text)["error"]["type"] != "deadline":
        fail(f"{label}: an expired deadline -> {status} {text}")
    # /loadz and /metrics at rest.
    time.sleep(0.5)
    loadz = json.loads(http(base, "/loadz")[2])
    missing = [k for k in LOADZ_KEYS if k not in loadz]
    if missing or loadz["role"] != "both" or loadz["max_slots"] != 24 or loadz["max_queue"] != 4:
        fail(f"{label}: /loadz lacks {missing} or differs: {loadz}")
    metrics = scrape(base)
    s = metrics["samples"]
    ttft = s.get("substratus_serve_ttft_seconds_count", 0)
    out["served"] = served
    return out, ttft, loadz, metrics


def surface_stream(base: str, prompt: str, max_tokens: int, during=None) -> tuple:
    """(text, usage, finish) of a greedy streamed completion; `during` runs
    (on another thread) once the first chunk is in."""
    body = {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True}}
    extra, threads = {}, []

    def started():
        if during is not None:
            threads.append(threading.Thread(target=lambda: extra.update(during() or {})))
            threads[0].start()

    status, _, text = http(base, "/v1/completions", body, on_first=started)
    for thread in threads:
        thread.join()
    if status != 200:
        fail(f"serve-surface: a stream answered {status}: {text[:200]}")
    pieces, finish, usage, done = sse_parse(text)
    if not done or len(pieces) != usage["completion_tokens"] + 1:
        fail(f"serve-surface: a stream ended without [DONE] or with {len(pieces)} chunks for {usage}")
    return "".join(pieces), usage, finish, extra


def polled_journey(base: str, trace: str, done: threading.Event, label: str) -> list:
    """Every event of a request's journey, however long its stream: the
    ring (the newest 256 events) polled from /debug/requestz?id= every
    0.2 s until `done` is set and once after, merged by position (the
    ring's first event is number total - len(events)). None when the
    polls missed an event (the caller fails: this runs on a thread)."""
    seen, total = {}, None
    while True:
        finished = done.is_set()
        status, _, text = http(base, f"/debug/requestz?id={trace}", timeout=60)
        if status == 200:
            j = json.loads(text)["journey"]
            total = j["total"]
            first = total - len(j["events"])
            seen.update((first + k, e) for k, e in enumerate(j["events"]))
        if finished:
            break
        time.sleep(0.2)
    if total is None or sorted(seen) != list(range(total)):
        print(f"{label}: the journey of {trace} was not read whole ({len(seen)} of {total} events)", flush=True)
        return None
    return [seen[i] for i in range(total)]


def swap_departure(ref, prompt_ids, plain, got, landing: int, eos: int) -> dict:
    """Where a stream swapped mid-stream departs from the unswapped run
    (`plain`): token for token up to the swap's landing (`landing` tokens
    emitted before the journey's swap event), then the first differing
    token of each run against a teacher-forced forward of the served
    weights (`ref`: cfg, params) over the prompt and the common prefix,
    the rule of against_plain: a near-tie is both picks within 5% of the
    row's logit scale."""
    import torch

    from substratus_tpu_torch.models import llama

    cfg, params = ref
    i = next((j for j, (x, y) in enumerate(zip(got, plain)) if x != y), None)
    if i is None and len(got) == len(plain):
        return {"at": None, "landing": landing, "near_tie": True}
    i = min(len(got), len(plain)) if i is None else i
    pick = [t[i] if i < len(t) else eos for t in (got, plain)]  # a stream that stopped there sampled EOS
    with torch.inference_mode():
        logits, _ = llama.forward(params, torch.tensor([prompt_ids + plain[:i]], device=params.device), cfg)
    row = logits[0, -1]
    scale = row.abs().max().item()
    gaps = [(row.max() - row[t]).item() for t in pick]
    return {"at": i, "landing": landing, "tokens": pick, "gaps": gaps, "logit_scale": scale,
            "near_tie": i >= landing and max(gaps) <= 0.05 * scale}


def surface_swap(base: str, paths: dict, label: str, tok) -> dict:
    """Leg (b): a swap to the same file mid-stream leaves the stream as an
    unswapped run's up to the swap's landing round and departs from it, if
    at all, at a near-tie (swap_departure: the swap's flush replans the
    next rounds from the settled history, as JAX does, so the int4
    kernels' row counts can change and a bf16 near-tie flip); a swap to the
    seed-1 file mid-stream is caught as more than a near-tie, and seed 1
    changes a greedy completion and bumps the version; back to seed 0
    gives the first completion again; the 2-layer file gets 409 and the
    version stays; no graph is captured twice."""
    import torch

    from substratus_tpu_torch.serve import main as serve_main

    def swap(path, want_status=200):
        t0 = time.perf_counter()
        status, _, text = http(base, "/swapz", {"checkpoint": str(path)})
        if status != want_status:
            fail(f"{label}: /swapz {path.name} -> {status} {text[:300]}")
        return json.loads(text), time.perf_counter() - t0

    def version():
        return json.loads(http(base, "/loadz")[2])["weights_version"]

    def graphs(metrics):
        s = metrics["samples"]
        used = sorted(k[len("substratus_serve_replays_"):] for k, v in s.items()
                      if k.startswith("substratus_serve_replays_") and v > 0)
        return int(s.get("substratus_serve_graph_warmups", 0)), used

    def traced(i, during=None):
        """A 160-token stream under its own trace id: its served ids (the
        journey's emits) and how many were emitted before a swap landed."""
        trace = f"{0x5b:08x}{i:024x}"
        body = {"prompt": prompt, "max_tokens": 160, "temperature": 0, "stream": True,
                "stream_options": {"include_usage": True}}
        extra, threads = {}, []

        def started():
            if during is not None:
                threads.append(threading.Thread(target=lambda: extra.update(during())))
                threads[0].start()

        done, journey = threading.Event(), []
        poller = threading.Thread(target=lambda: journey.append(polled_journey(base, trace, done, label)))
        poller.start()
        t0 = time.perf_counter()
        status, _, text = http(base, "/v1/completions", body, headers={"traceparent": f"00-{trace}-{'ab' * 8}-01"},
                               on_first=started)
        stream_s = time.perf_counter() - t0
        done.set()
        for thread in threads + [poller]:
            thread.join()
        if status != 200 or not journey or journey[0] is None:
            fail(f"{label}: a stream answered {status} ({text[:200]}) or its journey was not read whole")
        events = journey[0]
        names = [e[1] for e in events]
        landing = sum(1 for e in events[:names.index("swap")] if e[1] == "emit") if "swap" in names else None
        if during is not None and (landing is None or extra["swapped_at"] - t0 >= stream_s):
            fail(f"{label}: the stream ended before the swap landed ({names[-6:]})")
        return emitted(events), landing, extra

    before = graphs(scrape(base))
    prompt = "a long prompt runs"  # fewer than 16 tokens: no page is registered, every run prefills it whole
    prompt_ids = tok.encode(prompt)
    # The served weights, loaded here as the child loads them (the same
    # GGUF, dequantized, quantized to int4): the rule's reference.
    cfg, ref_params, _, _, _, _ = serve_main.load_model(str(paths["seed0"]), None, SURFACE_PARAMS,
                                                        torch.device("cuda"), "int4")
    plain, _, _ = traced(0)
    v0 = version()
    swapped, landing, extra = traced(1, lambda: {"swap": swap(paths["seed0"]), "swapped_at": time.perf_counter()})
    same = swap_departure((cfg, ref_params), prompt_ids, plain, swapped, landing, tok.eos_id)
    if not same["near_tie"]:
        fail(f"{label}: a swap to the same weights mid-stream departs from the unswapped run by more than a "
             f"near-tie (or before the swap landed): {same}")
    first, _, _, _ = surface_stream(base, prompt, 64)
    planted, p_landing, p_extra = traced(2, lambda: {"swap": swap(paths["seed1"]), "swapped_at": time.perf_counter()})
    fault = swap_departure((cfg, ref_params), prompt_ids, plain, planted, p_landing, tok.eos_id)
    if fault["near_tie"] or fault["at"] is None:
        fail(f"{label}: the rule did not catch a mid-stream swap to the seed-1 file: {fault}")
    del ref_params
    gc.collect()
    torch.cuda.empty_cache()
    seconds1 = p_extra["swap"][1]
    other, _, _, _ = surface_stream(base, prompt, 64)
    if version() != v0 + 2 or p_extra["swap"][0]["weights_version"] != v0 + 2 or other == first:
        fail(f"{label}: the seed-1 swap: {p_extra['swap'][0]}, its completion {other[:80]!r} (seed 0: {first[:80]!r})")
    reply, seconds0 = swap(paths["seed0"])
    again, _, _, _ = surface_stream(base, prompt, 64)
    if again != first:
        fail(f"{label}: back on seed 0 the completion is {again!r}, first {first!r}")
    rejected, _ = swap(paths["two_layers"], 409)
    if rejected["error"]["type"] != "swap_rejected" or version() != v0 + 3:
        fail(f"{label}: the 2-layer swap: {rejected}, version {version()}")
    after = graphs(scrape(base))
    new = sorted(set(after[1]) - set(before[1]))
    if after[0] != len(after[1]) or after[0] != before[0] + len(new):
        fail(f"{label}: {after[0]} captures for the graphs {after[1]} (before: {before}): a graph was captured again")
    departed = ("token for token" if same["at"] is None else
                f"token for token to the landing, then at token {same['at']} a near-tie (gaps "
                f"{[round(g, 4) for g in same['gaps']]} at logit scale {same['logit_scale']:.4g})")
    print(f"{label}: a swap to the same file mid-stream (landing after {landing} of {len(swapped)} tokens) left the "
          f"stream {departed}; the seed-1 swap mid-stream (landing after {p_landing}) departs at token {fault['at']} "
          f"by gaps {[round(g, 4) for g in fault['gaps']]} at logit scale {fault['logit_scale']:.4g}: caught; seed 1 "
          f"changed the completion, seed 0 again gave the first one; swaps took {extra['swap'][1]:.1f}, "
          f"{seconds1:.1f} and {seconds0:.1f} s (load, quantize, install); the 2-layer file 409; graphs captured "
          f"{before[0]} before, {after[0]} after ({after[1]})", flush=True)
    return {"swap_seconds": [extra["swap"][1], seconds1, seconds0], "captures_before": before[0],
            "captures_after": after[0], "graphs": after[1], "weights_version": version(), "same_file": same,
            "planted": fault}


def surface_profile(base: str, label: str) -> dict:
    """Leg (d): a 2 s /debug/profile under traffic of short prompts (one
    chunk of 16 rows each: the int4 matmul's decode design) names
    q4_matmul_decode_kernel."""
    stop = threading.Event()

    def traffic():
        i = 0
        while not stop.is_set():
            http(base, "/v1/completions", {"prompt": f"the card {i}", "max_tokens": 8, "temperature": 0})
            i += 1

    threads = [threading.Thread(target=traffic) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    try:
        status, _, text = http(base, "/debug/profile", {"seconds": 2})
    finally:
        stop.set()
        for t in threads:
            t.join()
    reply = json.loads(text) if status == 200 else fail(f"{label}: /debug/profile -> {status} {text}")
    traces = [f for f in reply["files"] if f.endswith(".json")]
    if not traces:
        fail(f"{label}: the capture wrote no trace: {reply}")
    trace = Path(traces[0]).read_text()
    names = ("q4_matmul_decode_kernel", "q4_matmul_wgmma_kernel")
    found = {n: trace.count(n) for n in names}
    if not found["q4_matmul_decode_kernel"]:
        fail(f"{label}: the trace does not name q4_matmul_decode_kernel ({found}; {len(trace)} bytes)")
    print(f"{label}: a 2 s capture under traffic, a trace of {len(trace)} bytes naming {found}", flush=True)
    shutil.rmtree(reply["dir"], ignore_errors=True)
    return {"trace_bytes": len(trace), "kernel_mentions": found}


# The traces of serve-surface: the child's own (TRACEPARENT) and two requests'.
SURFACE_TRACE = ("5e" * 16, "a1" * 8)
REQUEST_TRACES = ("7a" * 16, "7b" * 16)
# The keys of the JAX server's /debug pages (substratus_tpu/serve/server.py).
DEBUG_KEYS = {"/debug/tracez": {"traces", "latency_buckets", "buffered_spans", "dropped_spans"},
              "/debug/requestz": {"inflight", "queue_depth", "journeys"},
              "/debug/perfz": {"phases", "first_compile_seconds", "latencies", "occupancy", "train_phases", "engine"},
              "/debug/slowz": {"slow", "total_breaching", "slo", "exemplars"},
              "/debug/eventz": {"events", "dropped"}}


def traceparent(trace_id: str, span_id: str = "cd" * 8) -> str:
    return f"00-{trace_id}-{span_id}-01"


def surface_trace(base: str, label: str) -> dict:
    """Leg (e): two greedy requests, one whole and one streamed, each under
    its own traceparent: x-trace-id is its trace id (the stream's with its
    headers); /debug/tracez holds each trace rooted at serve.http with the
    engine's spans beside it; /debug/requestz?id= gives each one's journey,
    from submit through admit, its drains and speculative rounds to its
    end; the other /debug pages answer with the JAX keys."""
    prompt = "the pages of a long prompt decode the pages of a long prompt decode the pages of a long"
    out = {}
    for trace_id, stream in zip(REQUEST_TRACES, (False, True)):
        body = {"prompt": prompt, "max_tokens": 48, "temperature": 0, "stream": stream}
        status, headers, text = http(base, "/v1/completions", body, {"traceparent": traceparent(trace_id)})
        if status != 200 or headers.get("x-trace-id") != trace_id:
            fail(f"{label}: {'streamed' if stream else 'whole'} -> {status}, x-trace-id {headers.get('x-trace-id')}")
    time.sleep(0.5)
    pages = {}
    for page, keys in DEBUG_KEYS.items():
        status, _, text = http(base, page)
        pages[page] = json.loads(text) if status == 200 else fail(f"{label}: {page} -> {status} {text[:200]}")
        if set(pages[page]) != keys:
            fail(f"{label}: {page} keys {sorted(pages[page])}, the JAX server's {sorted(keys)}")
    traces = {tr["trace_id"]: tr for tr in pages["/debug/tracez"]["traces"]}
    journeys = {}
    for trace_id in REQUEST_TRACES:
        tr = traces.get(trace_id)
        if tr is None or tr["root"] != "serve.http" or tr["spans"] < 2 or tr["status"] != "ok":
            fail(f"{label}: /debug/tracez has {tr} for trace {trace_id}")
        status, _, text = http(base, f"/debug/requestz?id={trace_id}")
        if status != 200:
            fail(f"{label}: /debug/requestz?id={trace_id} -> {status} {text[:200]}")
        j = json.loads(text)
        types = [e[1] for e in j["journey"]["events"]]
        need = ("submit", "admit", "prefill", "drain", "spec_round", "emit", "end")
        if j["journey"]["trace_id"] != trace_id or types[0] != "submit" or types[-1] != "end" \
                or any(t not in types for t in need) or not j["waterfall"] or not j["chrome_trace"]["traceEvents"]:
            fail(f"{label}: the journey of {trace_id}: {types}")
        journeys[trace_id] = {t: types.count(t) for t in dict.fromkeys(types)}
    out = {"journeys": journeys, "spans_in_ring": pages["/debug/tracez"]["buffered_spans"],
           "perfz_phases": sorted(pages["/debug/perfz"]["phases"])}
    print(f"{label}: x-trace-id on the whole and the streamed request; /debug/tracez roots both at serve.http "
          f"({out['spans_in_ring']} spans in the ring); their journeys by event type {journeys}; /debug/perfz, "
          f"/slowz, /eventz, /requestz answer with the JAX keys", flush=True)
    return out


def surface_stepz(base: str, label: str) -> dict:
    """/debug/stepz parses as a Chrome trace: the bubble totals by cause,
    the floor estimate and the iterations of the child's run so far; and
    /debug/eventz holds the profile capture's events."""
    status, _, text = http(base, "/debug/stepz")
    body = json.loads(text) if status == 200 else fail(f"{label}: /debug/stepz -> {status}")
    iters = [e for e in body["traceEvents"] if e.get("name") == "iteration" and e.get("ph") == "X"]
    bubble = body["otherData"]["bubble"]
    if not iters or bubble["iterations"] < len(iters) or set(bubble["by_cause"]) != {
            "host_overrun", "flush", "admission_stall", "pool_dry"}:
        fail(f"{label}: /debug/stepz: {len(iters)} iteration events, {bubble}")
    events = json.loads(http(base, "/debug/eventz")[2])["events"]
    reasons = {e["reason"] for e in events}
    if "ProfileCaptureStopped" not in reasons:
        fail(f"{label}: /debug/eventz has no ProfileCaptureStopped: {reasons}")
    out = {"bubble": bubble, "floor_estimate_s": body["otherData"]["floor_estimate_s"],
           "iterations_recorded": len(iters)}
    print(f"{label}: /debug/stepz over the child's run: {bubble['iterations']} iterations, floor estimate "
          f"{out['floor_estimate_s']} s, gap {bubble['gap_s']} s, bubble seconds by cause {bubble['by_cause']} "
          f"(attributed {bubble['attributed_frac']}); /debug/eventz {sorted(reasons)}", flush=True)
    return out


def surface_export(path: Path, label: str) -> dict:
    """The child's span export at its exit: serve.start under the trace of
    its TRACEPARENT, each request's serve.http with engine.prefill under
    it."""
    spans = [json.loads(ln) for ln in path.read_text().splitlines()] if path.exists() else []
    start = [s for s in spans if s["name"] == "serve.start"]
    if len(start) != 1 or (start[0]["trace_id"], start[0]["parent_id"]) != SURFACE_TRACE:
        fail(f"{label}: the export holds serve.start {start} ({len(spans)} spans)")
    names = {}
    for trace_id in REQUEST_TRACES:
        mine = [s for s in spans if s["trace_id"] == trace_id]
        http_span = next((s for s in mine if s["name"] == "serve.http"), None)
        if http_span is None or not any(s["name"] == "engine.prefill" and s["parent_id"] == http_span["span_id"]
                                        for s in mine):
            fail(f"{label}: the export's spans of {trace_id}: {[s['name'] for s in mine]}")
        names[trace_id] = sorted(s["name"] for s in mine)
    print(f"{label}: at exit {path.name} held {len(spans)} spans: serve.start under TRACEPARENT's trace, "
          f"{names}", flush=True)
    return {"spans": len(spans), "by_request": names}


def surface_drain(child: SurfaceChild, base: str, label: str) -> dict:
    """Leg (c): SIGTERM during a 256-token stream: within 1 s readiness and
    /loadz 503 (draining), a new POST 503 with Retry-After; the stream ends
    whole and the child exits 0 within the grace."""
    seen = {}

    def term():
        t0 = time.perf_counter()
        seen["t_term"] = t0
        child.proc.send_signal(signal.SIGTERM)
        try:
            while time.perf_counter() - t0 < 5:
                if http(base, "/", timeout=5)[0] == 503:
                    seen["ready_503_s"] = time.perf_counter() - t0
                    break
                time.sleep(0.02)
            loadz = http(base, "/loadz", timeout=5)
            post = http(base, "/v1/completions", {"prompt": "x"}, timeout=5)
            seen.update(loadz=(loadz[0], json.loads(loadz[2]).get("draining")),
                        post=(post[0], post[1].get("Retry-After")))
        except OSError as e:  # the listener closed, or a read timed out: reported below
            seen["error"] = repr(e)
        return {}

    text, usage, finish, _ = surface_stream(base, SURFACE_PROMPT, 256, during=term)
    t_end = time.perf_counter()
    code = child.proc.wait(timeout=90)
    exit_s = time.perf_counter() - seen["t_term"]
    if seen.get("ready_503_s") is None or seen["ready_503_s"] > 1.0 or seen.get("loadz") != (503, True) \
            or seen["post"][0] != 503 or int(seen["post"][1] or 0) < 1:
        fail(f"{label}: after SIGTERM: {seen}")
    if t_end - seen["t_term"] < seen["ready_503_s"]:
        fail(f"{label}: the stream ended before readiness turned: {seen}")
    if code != 0 or exit_s > 60:
        fail(f"{label}: the child exited {code} {exit_s:.1f} s after SIGTERM: {''.join(child.lines[-10:])}")
    print(f"{label}: SIGTERM mid-stream: readiness 503 after {seen['ready_503_s'] * 1e3:.0f} ms, /loadz 503 draining, "
          f"a new POST 503 Retry-After {seen['post'][1]}; the stream ended whole ({usage['completion_tokens']} tokens, "
          f"{finish}); exit 0 {exit_s:.1f} s after SIGTERM", flush=True)
    return {"ready_503_ms": seen["ready_503_s"] * 1e3, "stream_tokens": usage["completion_tokens"],
            "exit_s": exit_s}


def serve_surface_phase(card: str) -> dict:
    """The container contract's serving surface at llama2-7b's full width:
    serve.main as a child process on a Q4_0 GGUF with a chat template, with
    the throughput example's params, under TRACEPARENT with
    SUBSTRATUS_TRACE_EXPORT, in five legs: (a) the contract, (e) the trace
    and the /debug pages, (b) hot weight swaps, (d) /debug/profile, (c) the
    drain on SIGTERM; then the export the child wrote at its exit."""
    import os
    import tempfile

    import torch

    from substratus_tpu_torch.load.gguf import tokenizer_from_gguf

    label = "serve-surface"
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_surface_"))
    child = None
    try:
        paths = write_surface_checkpoints(tmp)
        tok = tokenizer_from_gguf(str(paths["seed0"]))
        env = {**os.environ, "PROFILE_DIR": str(tmp / "profile"),
               "PYTHONPATH": str(Path(__file__).resolve().parent) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "TRACEPARENT": traceparent(*SURFACE_TRACE), "SUBSTRATUS_TRACE_EXPORT": str(tmp / "spans.jsonl")}
        child = SurfaceChild(paths["seed0"], SURFACE_PARAMS, env)
        base, ready_s = child.wait_ready()
        print(f"{label}: serve.main ready in {ready_s:.1f} s (a child process: load, int4, engine, first request "
              f"aside)", flush=True)
        http(base, "/v1/completions", {"prompt": "warm up", "max_tokens": 2, "temperature": 0})
        time.sleep(0.5)
        m0 = scrape(base)
        counts0, forwards0 = surface_launches(m0), surface_forwards(m0)
        contract, ttft_count, loadz, metrics = surface_contract(base, tok, f"{label} (a)")
        served = contract["served"] + 1  # and the warm-up
        s = metrics["samples"]
        spec = loadz["spec"]
        if ttft_count != served or s.get("substratus_serve_spec_proposed_tokens_total") != spec["proposed_tokens"] \
                or s.get("substratus_serve_spec_accepted_tokens_total") != spec["accepted_tokens"] \
                or not spec["proposed_tokens"]:
            fail(f"{label} (a): TTFT count {ttft_count} for {served} requests served; spec totals "
                 f"{s.get('substratus_serve_spec_proposed_tokens_total')}/"
                 f"{s.get('substratus_serve_spec_accepted_tokens_total')} against /loadz {spec}")
        decode = (s['substratus_serve_phase_seconds_sum{phase="decode"}'],
                  s['substratus_serve_phase_seconds_count{phase="decode"}'])
        step_ms = 1e3 * decode[0] / decode[1]
        print(f"{label} (a) [{card}]: chat held by the template, stop whole and streamed, {contract['burst']}, 504, "
              f"/loadz keys, /metrics: TTFT count {ttft_count} = {served} requests, spec totals {spec}; the served "
              f"mean decode round from the phase histogram {step_ms:.2f} ms over {int(decode[1])} rounds", flush=True)
        trace = surface_trace(base, f"{label} (e)")
        swap = surface_swap(base, paths, f"{label} (b)", tok)
        profile = surface_profile(base, f"{label} (d)")
        time.sleep(0.5)
        stepz = surface_stepz(base, f"{label} (e)")
        m1 = scrape(base)
        counts1 = surface_launches(m1)
        launches = {k: counts1.get(k, 0) - counts0.get(k, 0) for k in counts1}
        forwards = surface_forwards(m1) - forwards0
        by_design = {"q4_matmul_decode": launches.get("q4_matmul.launches_decode", 0),
                     "q4_matmul_wgmma": launches.get("q4_matmul.launches_wgmma", 0),
                     "q4_matmul": launches.get("q4_matmul.launches_mma", 0)}
        if not by_design["q4_matmul_decode"] or not by_design["q4_matmul_wgmma"] or by_design["q4_matmul"] \
                or sum(by_design.values()) != launches.get("q4_matmul.launches", -1) \
                or launches["q4_matmul.launches"] != (7 * paths["n_layers"] + 1) * forwards:
            fail(f"{label}: int4 launches {launches} against {forwards} forwards of {7 * paths['n_layers'] + 1} int4 "
                 "matmuls")
        print(f"{label}: int4 matmul launches of legs (a), (b), (d) by design {by_design}: {forwards} forwards "
              f"(prefill chunks, rounds and the verify graphs' warm-ups) of {7 * paths['n_layers'] + 1} each, none "
              "through q4_matmul.cu", flush=True)
        drain = surface_drain(child, base, f"{label} (c)")
        export = surface_export(tmp / "spans.jsonl", f"{label} (e)")
    finally:
        if child is not None:
            child.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"{label}: {wall:.1f} s", flush=True)
    return {"ready_s": ready_s, "contract": contract, "step_ms": step_ms, "decode_rounds": int(decode[1]),
            "swap": swap, "profile": profile, "drain": drain, "launches": by_design, "all_launches": launches,
            "trace": trace, "stepz": stepz, "export": export, "seconds": wall}


# --- training: train.main and the Trainer ----------------------------------------

# The finetune example's params (examples/llama2-7b/finetuned-model.yaml):
# LoRA rank 16, batch 8 x 1024, learning rate 2e-4; 4 steps and checkpoints
# every 2 here, then a second call to 6 steps resumes from step 4.
TRAIN_PARAMS = {"config": "llama2-7b", "lora_rank": 16, "lora_alpha": 16, "batch_size": 8, "seq_len": 1024,
                "learning_rate": 2e-4, "save_steps": 2, "remat": True, "seed": 0}
TRAIN_STEPS = (4, 6)
# The phase's depth: 4 of llama2-7b's 32 layers, cut so that the default run
# stays well inside its time limit (8, then 4 once serve-gang's llama2-70b
# leg joined it; every check as at full depth).
TRAIN_LAYERS = 4
# Gradients through the kernels against attn_impl="plain": the two paths
# round attention differently in bf16 (the kernels round p to bf16 before
# PV, the plain path keeps the softmax in f32), and the difference passes
# through every layer's backward, a few percent in the worst tensors; a
# wrong mask, scale or GQA sum gives cosines far below.
GRAD_COS_ALL = 0.999  # every trainable gradient as one vector
GRAD_COS = 0.99  # each tensor
GRAD_REL = 0.15  # each tensor: |g - ref| / |ref| (Frobenius)


def _zero_train_counts() -> None:
    from substratus_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)

    for c in (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv):
        c.launches = c.launches_wgmma = c.launches_mma = 0


def _train_launches() -> dict:
    """The launches of each kernel's wgmma design (llama2-7b's head_dim
    128), with every launch of the kernel in `_all` (equal unless another
    design ran)."""
    from substratus_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)

    return {"flash_fwd": flash_attention.launches_wgmma, "flash_fwd_all": flash_attention.launches,
            "flash_bwd_dq": flash_attention_bwd_dq.launches_wgmma, "flash_bwd_dq_all": flash_attention_bwd_dq.launches,
            "flash_bwd_dkv": flash_attention_bwd_dkv.launches_wgmma,
            "flash_bwd_dkv_all": flash_attention_bwd_dkv.launches}


def _grad_cosine(grads, refs):
    """(cosine over all as one vector, worst per-tensor cosine, worst
    per-tensor relative error) of two lists of gradients; fails on a
    non-finite one or on a gradient the reference gives as 0 that is not."""
    import torch

    worst_cos, worst_rel, dot, n_g, n_ref = 1.0, 0.0, 0.0, 0.0, 0.0
    for g, ref in zip(grads, refs):
        g, ref = g.float().flatten(), ref.float().flatten()
        if not torch.isfinite(g).all():
            fail("non-finite gradients")
        dot, n_g, n_ref = dot + (g @ ref).item(), n_g + (g @ g).item(), n_ref + (ref @ ref).item()
        if ref.norm().item() == 0.0:
            if g.norm().item() != 0.0:
                fail("a gradient the plain path gives as 0 is not 0 through the kernels")
            continue
        worst_cos = min(worst_cos, (g @ ref / (g.norm() * ref.norm()).clamp(min=1e-30)).item())
        worst_rel = max(worst_rel, ((g - ref).norm() / ref.norm()).item())
    return dot / max((n_g * n_ref) ** 0.5, 1e-30), worst_cos, worst_rel


class pin_routing:
    """Record a mixture of experts' routing (models/llama.py::route, each
    call's top-k experts) in one pass, and replay it in the next: the
    replaying pass takes the recorded experts, weighted by its own router
    probabilities. Two correct bf16 paths (the attention kernels against
    the plain attention) round a token's state differently, and where the
    router's k-th and (k+1)-th probabilities nearly tie, one would pick
    another expert (and under capacity dispatch drop other pairs): a
    discrete change no gradient tolerance covers. Pinned, the two passes
    differ only in the attention's rounding, which is what the gradient
    check holds. Counts the choices the replaying pass would have made
    otherwise."""

    def __init__(self, llama_module):
        self.module, self.route = llama_module, llama_module.route
        self.seen, self.calls, self.flips, self.choices = [], 0, 0, 0

    def start(self, replay: bool) -> None:
        import torch

        self.i = 0

        def routed(h, router, k):
            probs, top_w, top_idx = self.route(h, router, k)
            if not replay:
                self.seen.append(top_idx)
                self.calls += 1
                return probs, top_w, top_idx
            pinned = self.seen[self.i]
            self.i += 1
            self.flips += int((torch.sort(top_idx, -1).values != torch.sort(pinned, -1).values).any(-1).sum())
            self.choices += pinned[..., 0].numel()
            w = probs.gather(-1, pinned)
            return probs, w / w.sum(dim=-1, keepdim=True), pinned

        self.module.route = routed

    def stop(self) -> None:
        self.module.route = self.route


def grad_check(trainer, batch, label: str, twin_floor: bool = False) -> dict:
    """One step's gradients of the trainer's trainable tensors through the
    kernels and through attn_impl="plain" (same weights, same batch; OPT
    and Falcon, which have no switch, through their module's attention
    swapped for the plain one). twin_floor: also through autograd of the
    kernels' plain twin, flash_attention_plain (p rounded to bf16 as the
    kernels round it), and the cosine over all need only lie within twice
    the twin's own distance from the plain path when that is the nearer
    bar (OPT's gradients at opt-2.7b's width: two correct bf16 attentions
    lie 0.9988-0.9991 apart at any depth, tools/grad_probe.py); the
    per-tensor limits stay."""
    import numpy as np
    import torch

    from substratus_tpu_torch.ops.attention import dot_product_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention_plain

    tokens = torch.from_numpy(np.asarray(batch["tokens"])).to(trainer.device, torch.long)
    weights = torch.from_numpy(batch["weights"]).to(trainer.device)
    cfg, kernel = trainer.cfg, getattr(trainer.model, "flash_attention", None)
    pinned = pin_routing(trainer.model) if getattr(cfg, "n_experts", 0) > 0 else None
    swapped = {"plain": lambda q, k, v, causal: dot_product_attention(q, k, v, causal=causal),
               "twin": lambda q, k, v, causal: flash_attention_plain(q, k, v, causal)}
    grads = {}
    for impl in ("flash", "plain") + (("twin",) if twin_floor else ()):
        if hasattr(cfg, "attn_impl") and impl != "twin":
            trainer.cfg = cfg.replace(attn_impl=impl)
        elif impl != "flash":
            trainer.model.flash_attention = swapped[impl]
        if pinned is not None:
            pinned.start(replay=impl != "flash")
        try:
            loss = trainer.loss(tokens, weights)  # the step's loss (a mixture of experts adds its aux)
            grads[impl] = torch.autograd.grad(loss, trainer.trainable)
        finally:
            trainer.cfg = cfg
            if kernel is not None:
                trainer.model.flash_attention = kernel
            if pinned is not None:
                pinned.stop()
    all_cos, worst_cos, worst_rel = _grad_cosine(grads["flash"], grads["plain"])
    bar, twin = GRAD_COS_ALL, None
    if twin_floor:
        twin = _grad_cosine(grads["twin"], grads["plain"])
        bar = min(GRAD_COS_ALL, 1 - 2 * (1 - twin[0]))
    print(f"{label}: {len(grads['flash'])} trainable tensors' gradients through the kernels against attn_impl=plain: "
          f"cosine {all_cos:.6f} over all (at least {bar:.6f}"
          + (f": the kernels' plain twin's own cosine {twin[0]:.6f} (worst tensor {twin[1]:.6f}, relative error "
             f"{twin[2]:.4g}), at most twice as far from 1" if twin else "")
          + f"); per tensor worst cosine {worst_cos:.6f} (at least {GRAD_COS}), worst relative error {worst_rel:.4g} "
          f"(at most {GRAD_REL})", flush=True)
    if all_cos < bar or worst_cos < GRAD_COS or worst_rel > GRAD_REL:
        fail(f"{label}: gradients through the kernels disagree with the plain path")
    out = {"cosine_all": all_cos, "worst_cosine": worst_cos, "worst_rel_err": worst_rel, "tensors": len(grads["flash"])}
    if pinned is not None:
        out["routing_flips"] = pinned.flips
        print(f"{label}: the plain pass routed as the kernels' pass ({pinned.calls} router calls); left to itself it "
              f"would have picked other experts for {pinned.flips} of {pinned.choices} (token, layer) choices",
              flush=True)
    if twin:
        out.update(bar=bar, twin_cosine_all=twin[0], twin_worst_cosine=twin[1], twin_worst_rel_err=twin[2])
    return out


def profile_train_step(trainer, batch, label: str) -> dict:
    """One more optimizer step under torch.profiler: host-clock and device
    busy time, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    out = _device_summary(prof, time.perf_counter() - t0, 1)
    print(f"{label} profile: step {out['profiled_ms']:.1f} ms under the profiler, device busy "
          f"{out['device_busy_ms']:.1f} ms ({100 * out['device_busy_ms'] / out['profiled_ms']:.1f}%), "
          f"GEMMs {out['gemm_ms']:.1f} ms; flash kernels, ms: "
          + ", ".join(f"{name} {ms:.2f}" for name, ms in out["flash_ms"].items()), flush=True)
    for e in out["top"]:
        print(f"{label} profile: {e['ms']:8.3f} ms {e['calls']:6.1f} calls  {e['name'][:80]}", flush=True)
    return out


# The resumed train.main call's profile window (steps 4 and 5) and trace.
TRAIN_PROFILE = [4, 5]
TRAIN_TRACE = ("7ea1" * 8, "5b" * 8)


class _Tee:
    """stdout that also keeps what is written."""

    def __init__(self, stream):
        self.stream, self.text = stream, []

    def write(self, s):
        self.text.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


class traced_run:
    """With TRACEPARENT set to `tp` (unless None) and stdout kept: the
    context's value is the list of lines written."""

    def __init__(self, tp):
        self.tp, self.lines = tp, []

    def __enter__(self):
        import os

        self.old = os.environ.get("TRACEPARENT")
        if self.tp is not None:
            os.environ["TRACEPARENT"] = self.tp
        self.tee = _Tee(sys.stdout)
        sys.stdout = self.tee
        return self.lines

    def __exit__(self, *exc):
        import os

        sys.stdout = self.tee.stream
        self.lines.extend("".join(self.tee.text).splitlines())
        if self.tp is not None:
            if self.old is None:
                os.environ.pop("TRACEPARENT", None)
            else:
                os.environ["TRACEPARENT"] = self.old
        return False


def step_seconds_count() -> int:
    """The steps substratus_train_step_seconds has counted in this process."""
    from substratus_tpu_torch.observability.metrics import METRICS

    return METRICS.histogram_series("substratus_train_step_seconds").get("", {}).get("count", 0)


def train_trace_checks(out: Path, res: dict, lines, counted: int, label: str) -> dict:
    """The resumed call's telemetry: the profile window's trace names the
    flash forward and both backward kernels; trace.jsonl holds train.run
    under TRACEPARENT's trace; each progress line carries the trace id; the
    registry counted each step once in substratus_train_step_seconds."""
    window, trace_path = res["profile_window"], res["profile_trace"]
    if window != tuple(TRAIN_PROFILE) or trace_path is None or not Path(trace_path).is_file():
        fail(f"{label}: profile window {window}, trace {trace_path}")
    trace = Path(trace_path).read_text()
    names = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel")
    found = {n: trace.count(n) for n in names}
    if not all(found.values()):
        fail(f"{label}: the profile of steps {window} names {found} ({len(trace)} bytes)")
    spans = [json.loads(ln) for ln in (out / "trace.jsonl").read_text().splitlines()]
    run = [s for s in spans if s["name"] == "train.run" and s["trace_id"] == TRAIN_TRACE[0]]
    if len(run) != 1 or run[0]["parent_id"] != TRAIN_TRACE[1]:
        fail(f"{label}: trace.jsonl's train.run spans {[s for s in spans if s['name'] == 'train.run']}")
    progress = [json.loads(ln) for ln in lines if ln.startswith('{"event":"train_step"')]
    if not progress or any(ln.get("trace_id") != TRAIN_TRACE[0] for ln in progress):
        fail(f"{label}: progress lines {progress}")
    if counted != len(res["losses"]):
        fail(f"{label}: substratus_train_step_seconds counted {counted} steps, {len(res['losses'])} ran")
    print(f"{label}: the resumed call's profile of steps {window[0]}..{window[1]}: {len(trace)} bytes naming {found}; "
          f"train.run under TRACEPARENT's trace in trace.jsonl; {len(progress)} progress lines with its trace id; "
          f"substratus_train_step_seconds counted its {counted} steps", flush=True)
    return {"profile_window": list(window), "profile_trace_bytes": len(trace), "kernel_mentions": found,
            "progress_lines": len(progress), "step_seconds_count": counted}


def _step_stats(seconds, step_log) -> dict:
    """Median step seconds after the first (which warms up), and the
    tokens/s and MFU of train/telemetry.py's StepLogger at that median."""
    steady = statistics.median(seconds[1:] if len(seconds) > 1 else seconds)
    tokens_per_s, mfu = step_log.rates(steady)
    return {"step_s": seconds, "median_step_s": steady, "tokens_per_s": tokens_per_s, "mfu": mfu}


def train_phase(card: str, profile_steps: bool = False) -> dict:
    """llama2-7b LoRA through train.main, as described in the module
    docstring. Weights, corpus and artifacts live in a temporary
    directory that is removed at the end."""
    import tempfile

    import numpy as np
    import torch

    from substratus_tpu_torch.load.dataset import main as dataset_main
    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.ops.flash_attention import flash_attention
    from substratus_tpu_torch.train import main as train_main
    from substratus_tpu_torch.train.checkpoints import load_artifact
    from substratus_tpu_torch.train.data import PackedDataset
    from substratus_tpu_torch.train.trainer import TrainConfig, Trainer
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    gc.collect()  # the serving phases' engines and caches
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        (tmp / "src").mkdir()
        # A seeded token stream over the vocabulary: 2M tokens, 1953 blocks,
        # imported into the data directory by the dataset loader's files
        # source, as the container contract's dataset step does.
        np.save(tmp / "src" / "corpus.npy", np.random.default_rng(0).integers(0, 32000, 2_000_000, dtype=np.int32))
        (tmp / "dataset.json").write_text(json.dumps({"files": [str(tmp / "src" / "corpus.npy")]}))
        if dataset_main(["--out", str(tmp / "data"), "--params", str(tmp / "dataset.json")]) != 0 or \
                (tmp / "data" / "corpus.npy").read_bytes() != (tmp / "src" / "corpus.npy").read_bytes():
            fail("train: load.dataset did not import the corpus")
        free_gb = shutil.disk_usage(tmp).free / 1e9
        p = {**TRAIN_PARAMS, "config": at_depth(TRAIN_PARAMS["config"], TRAIN_LAYERS)}
        cfg = llama.CONFIGS[p["config"]]
        if (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.vocab_size) != (4096, TRAIN_LAYERS, 32, 32000):
            fail(f"train: not llama2-7b at full width and {TRAIN_LAYERS} layers: {cfg}")
        tc = TrainConfig(lora_rank=p["lora_rank"], lora_alpha=p["lora_alpha"], learning_rate=p["learning_rate"],
                         seed=p["seed"], remat=p["remat"])
        first = next(PackedDataset(str(tmp / "data"), ByteTokenizer(), p["batch_size"], p["seq_len"],
                                   seed=p["seed"]))

        # Before the run, on the weights train.main starts from (the same
        # seeds): the first batch's loss without grad, then one step's
        # adapter gradients through the kernels against the plain path,
        # with B drawn at random (B = 0 would give A no gradient).
        check = Trainer(cfg, tc, device="cuda")
        tokens = torch.from_numpy(first["tokens"]).to(check.device, torch.long)
        with torch.inference_mode():
            logits, _ = llama.forward(check.params, tokens, cfg)
            nograd_loss = torch.nn.functional.cross_entropy(logits[:, :-1].flatten(0, 1),
                                                            tokens[:, 1:].flatten()).item()
        del logits
        gen = torch.Generator(device="cuda").manual_seed(1)
        with torch.no_grad():
            for layer in check.lora.layers:
                for ab in layer.values():
                    ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device="cuda") * 1e-2)
        grads = grad_check(check, first, "train")
        del check
        gc.collect()
        torch.cuda.empty_cache()

        runs = []
        for steps in TRAIN_STEPS:
            params_path = tmp / f"params_{steps}.json"
            resumed = steps != TRAIN_STEPS[0]
            # The resumed call: a profile window over its two steps, under
            # TRACEPARENT, its progress lines kept.
            params_path.write_text(json.dumps(dict(p, steps=steps, **({"profile_steps": TRAIN_PROFILE} if resumed
                                                                       else {}))))
            _zero_train_counts()
            torch.cuda.reset_peak_memory_stats()
            counted = step_seconds_count()
            with traced_run(traceparent(*TRAIN_TRACE) if resumed else None) as lines:
                res = train_main.run(["--data", str(tmp / "data"), "--out", str(tmp / "out"),
                                      "--params", str(params_path)])
            if resumed:
                telemetry = train_trace_checks(tmp / "out", res, lines, step_seconds_count() - counted, "train")
            launches = _train_launches()
            n = len(res["losses"])
            L = cfg.n_layers
            want = {"flash_fwd": 2 * L * n, "flash_fwd_all": 2 * L * n, "flash_bwd_dq": L * n, "flash_bwd_dq_all": L * n,
                    "flash_bwd_dkv": L * n, "flash_bwd_dkv_all": L * n}
            if launches != want:
                fail(f"train: launches {launches} over {n} steps, want {want}")
            if not all(np.isfinite(res["losses"])):
                fail(f"train: non-finite losses {res['losses']}")
            runs.append({"start_step": res["start_step"], "losses": res["losses"], "launches": launches,
                         "checkpoint_s": res["checkpoint_seconds"], "artifact_s": res["artifact_seconds"],
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         **_step_stats(res["step_seconds"], res["step_log"])})
            if steps == TRAIN_STEPS[0]:
                del res
                gc.collect()
                torch.cuda.empty_cache()
        if runs[0]["start_step"] != 0 or runs[1]["start_step"] != TRAIN_STEPS[0] or res["trainer"].step != TRAIN_STEPS[1]:
            fail(f"train: the second call did not resume from step {TRAIN_STEPS[0]}: {runs}")
        # The first step's loss (rate 0, B = 0) against the no-grad forward.
        first_err = abs(runs[0]["losses"][0] - nograd_loss)
        if first_err > 1e-3 * nograd_loss:
            fail(f"train: first loss {runs[0]['losses'][0]} against the no-grad forward's {nograd_loss}")

        # The artifact (the merged model) reloads to the same logits.
        t0 = time.perf_counter()
        cfg2, model = load_artifact(str(tmp / "out"))
        load_s = time.perf_counter() - t0
        probe = tokens[:1, :256]
        with torch.inference_mode():
            want_logits, _ = llama.forward(res["merged"], probe, res["cfg"])
            got_logits, _ = llama.forward(model, probe, cfg2)
        reload_err = (got_logits - want_logits).abs().max().item()
        del model
        if reload_err != 0.0:
            fail(f"train: the reloaded artifact's logits differ by {reload_err}")
        served = serve_artifact(tmp / "out", res["merged"])
        del res["merged"]
        profiled = profile_train_step(res["trainer"], first, "train") if profile_steps else None
        artifact_bytes = (tmp / "out" / "params.pt").stat().st_size
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = runs
    print(f"train: llama2-7b at {TRAIN_LAYERS} layers, LoRA r16, batch 8 x 1024, {TRAIN_STEPS[0]} steps then "
          f"{TRAIN_STEPS[1] - TRAIN_STEPS[0]} "
          f"resumed; losses {r0['losses']} then {r1['losses']}; first loss {r0['losses'][0]:.6f} against "
          f"{nograd_loss:.6f} without grad; launches {r0['launches']} and {r1['launches']}", flush=True)
    print(f"train [{card}]: step {r0['median_step_s']:.3f} s (median after the first; all {r0['step_s']}), "
          f"{r0['tokens_per_s']:.0f} tokens/s, MFU {r0['mfu']}, peak {r0['peak_bytes'] / 2**30:.1f} GiB; "
          f"checkpoints {r0['checkpoint_s']} s; merged artifact {artifact_bytes} bytes written in "
          f"{r0['artifact_s']:.1f} s, reloaded in {load_s:.1f} s, logits max|diff| {reload_err}; "
          f"{free_gb:.0f} GB were free", flush=True)
    return {"runs": runs, "grad_check": grads, "nograd_loss": nograd_loss, "artifact_bytes": artifact_bytes,
            "artifact_load_s": load_s, "launches": r0["launches"], "served_artifact": served, "profile": profiled,
            "telemetry": telemetry}


def serve_artifact(path: Path, merged) -> dict:
    """The finetune -> serve loop: train.main's merged artifact through
    serve.main --model with serve's knobs, its weights bit for bit the
    trainer's merged model, its greedy tokens those of an in-process engine
    on that model."""
    import torch

    loads, restore = timed_loads()
    try:
        server, engine, base = start_server("train-artifact", {k: v for k, v in SERVE_PARAMS.items()
                                                               if k != "config"}, ["--model", str(path)],
                                            model=llama2_7b_at(TRAIN_LAYERS))
    finally:
        restore()
    requests = tee_requests(engine)
    try:
        same_state(engine.params, merged, "train artifact")
        results, wall = run_concurrent(base, PROMPTS)
        wait_idle(engine)
        del engine.submit
        same = eager_check(engine, requests, "train artifact", params=merged)
    finally:
        server.stop()
    generated = check_usage(PROMPTS, results)
    print(f"train: serve.main --model <the merged artifact> loaded it in {loads[0]:.2f} s; {len(PROMPTS)} requests, "
          f"{generated} tokens in {wall:.2f} s", flush=True)
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    return {"load_s": loads[0], "generated": generated, "same_as_merged": same}


def train_full_phase(card: str, profile_steps: bool = False) -> dict:
    """Full finetuning through the Trainer at llama2-7b's width, 4 layers,
    batch 2 x 1024, 3 steps."""
    import numpy as np
    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.train.telemetry import StepLogger, device_peak_flops
    from substratus_tpu_torch.train.trainer import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.CONFIGS["llama2-7b"].replace(n_layers=4)
    # Rate 1e-2: the norms' bf16 weights sit at 1.0, where a bf16 step is
    # 2^-7, so a smaller update rounds back to 1.0 (in the JAX trainer too).
    trainer = Trainer(cfg, TrainConfig(lora_rank=0, learning_rate=1e-2, warmup_steps=1, total_steps=3),
                      device="cuda")
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 1024), dtype=np.int32),
                "weights": np.ones((2, 1024), np.float32)} for _ in range(3)]
    grads = grad_check(trainer, batches[0], "train-full")
    names = [name for name, _ in trainer.params.named_parameters()]
    before = [t.detach().clone() for t in trainer.trainable]
    _zero_train_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, changed = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch))
        seconds.append(time.perf_counter() - t0)
        changed.append([not torch.equal(a, b) for a, b in zip(before, trainer.trainable)])
        before = [t.detach().clone() for t in trainer.trainable]
    launches = _train_launches()
    L = cfg.n_layers
    if launches != {"flash_fwd": 2 * L * 3, "flash_fwd_all": 2 * L * 3, "flash_bwd_dq": L * 3, "flash_bwd_dq_all": L * 3,
                    "flash_bwd_dkv": L * 3, "flash_bwd_dkv_all": L * 3}:
        fail(f"train-full: launches {launches} over 3 steps of {L} layers")
    if not all(np.isfinite(losses)):
        fail(f"train-full: non-finite losses {losses}")
    if any(changed[0]) or not all(changed[1]):
        fail(f"train-full: step 0 (rate 0) changed {[n for n, c in zip(names, changed[0]) if c]}; step 1 left "
             f"{[n for n, c in zip(names, changed[1]) if not c]} unchanged")
    n_params = sum(t.numel() for t in trainer.trainable)
    stats = _step_stats(seconds, StepLogger(n_params, 2 * 1024, device_peak_flops(trainer.device)))
    peak = torch.cuda.max_memory_allocated()
    profiled = profile_train_step(trainer, batches[0], "train-full") if profile_steps else None
    print(f"train-full: llama2-7b width, {L} layers ({n_params} weights, all trained), batch 2 x 1024; losses "
          f"{losses}; launches {launches}; step 0 changed no weight, step 1 all {len(names)}", flush=True)
    print(f"train-full [{card}]: step {stats['median_step_s']:.3f} s (all {seconds}), {stats['tokens_per_s']:.0f} "
          f"tokens/s, MFU {stats['mfu']}, peak {peak / 2**30:.1f} GiB", flush=True)
    return {"losses": losses, "launches": launches, "grad_check": grads, "peak_bytes": peak,
            "profile": profiled, **stats}


# --- serve-families: OPT and Falcon at full width ----------------------------

# examples/falcon-7b-instruct/server.yaml's params (max_batch 16; the rest
# serve.main's defaults: max_seq_len 1024, max_prefill_len 512, the dense
# cache, which auto resolves to for Falcon). 16 concurrent requests of
# 16-400 tokens and one of 600 (two chunks), 32 tokens each, one streamed,
# one at temperature 0.8 (ByteTokenizer ids: 1 + bytes).
FAMILY_PARAMS = {"max_batch": 16}
FAMILY_LENS = (16, 24, 40, 64, 100, 128, 160, 200, 240, 256, 300, 333, 360, 380, 400, 600)
FAMILY_PROMPTS = [(_long_text(n - 1, 40 + i), 32, 0.8 if i == 3 else 0.0, i == 1) for i, n in enumerate(FAMILY_LENS)]
# examples/facebook-opt-125m/finetuned-model.yaml's params.
OPT_TRAIN_PARAMS = {"steps": 10, "batch_size": 2, "seq_len": 256, "lora_rank": 8}
# The finetune example's LoRA (r16 on wq/wv, remat) on falcon-7b, two steps
# of batch 2 x 1024.
FALCON_TRAIN_PARAMS = {"config": "falcon-7b", "steps": 2, "batch_size": 2, "seq_len": 1024, "lora_rank": 16,
                       "lora_alpha": 16, "learning_rate": 2e-4, "save_steps": 2, "remat": True, "seed": 0}


def _serving_counters():
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_attention

    return flash_attention, flash_cached_attention, decode_attention


def _serving_launches(engine) -> dict:
    flash, cached, decode = _serving_counters()
    return {"flash_fwd": launched(engine, flash), "flash_fwd_wgmma": launched(engine, flash, "launches_wgmma"),
            "flash_cached": launched(engine, cached), "flash_cached_wgmma": launched(engine, cached, "launches_wgmma"),
            "decode_attn": launched(engine, decode), "decode_attn_split": launched(engine, decode, "launches_split")}


def _check_serving_launches(launches: dict, stats: dict, n_layers: int, label: str) -> None:
    """The flash forward once a layer per single-shot prefill, the cached
    flash per chunk and the decode kernel per decode step, each all of the
    design at head_dim 64 (wgmma, split)."""
    want = {"flash_fwd": n_layers * stats["prefills"], "flash_cached": n_layers * stats["prefill_chunks"],
            "decode_attn": n_layers * stats["decode_steps"]}
    want.update(flash_fwd_wgmma=want["flash_fwd"], flash_cached_wgmma=want["flash_cached"],
                decode_attn_split=want["decode_attn"])
    if launches != want or not launches["flash_fwd"] or not launches["decode_attn"]:
        fail(f"{label}: launches {launches}, want {want} ({stats['prefills']} prefills, {stats['prefill_chunks']} "
             f"chunks, {stats['decode_steps']} decode steps)")


def _token_corpus(path: Path, vocab: int, n: int) -> None:
    import numpy as np

    path.mkdir(parents=True, exist_ok=True)
    np.save(path / "corpus.npy", np.random.default_rng(0).integers(0, vocab, n, dtype=np.int32))


def families_falcon_serve(card: str, tmp: Path) -> dict:
    """(a) falcon-7b (seed 0, bf16) written by tools/ckpt_writer.py as an HF
    Falcon directory (the fused query_key_value per kv group) and served
    through serve.main --model with the example's params."""
    import torch

    from substratus_tpu_torch.models import falcon
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    label = "serve-families falcon-7b"
    cfg = falcon.CONFIGS["falcon-7b"].replace(n_layers=FALCON_LAYERS)
    source = falcon.init_params(cfg, seed=0, device="cuda")
    nbytes = sum(t.numel() * t.element_size() for t in source.state_dict().values())
    disk_room(tmp, nbytes, label)
    t0 = time.perf_counter()
    written = write_hf(str(tmp / "falcon-7b"), source)
    write_s = time.perf_counter() - t0
    config = json.loads((tmp / "falcon-7b" / "config.json").read_text())
    print(f"{label}: written as {len(written['files'])} safetensors shards, {written['bytes']} bytes in "
          f"{write_s:.1f} s; config.json model_type {config['model_type']}, multi_query {config['multi_query']}",
          flush=True)
    loads, restore = timed_loads()
    try:
        server, engine, base = start_server("serve-families-falcon", FAMILY_PARAMS,
                                            ["--model", str(tmp / "falcon-7b")], model=FALCON_7B)
    finally:
        restore()
    requests = tee_requests(engine)
    try:
        compared = same_state(engine.params, source, label)
        del source
        if engine.paged or engine.ec.max_batch != 16 or type(engine.cfg) is not falcon.FalconConfig:
            fail(f"{label}: not the dense cache at max_batch 16: paged={engine.paged}, {engine.ec}")
        zero_counts(engine, _serving_counters())
        results, wall = run_concurrent(base, FAMILY_PROMPTS)
        wait_idle(engine)
        launches = _serving_launches(engine)
        stats = dict(engine.stats)
        del engine.submit
    finally:
        server.stop()
    shutil.rmtree(tmp / "falcon-7b", ignore_errors=True)
    generated = check_usage(FAMILY_PROMPTS, results)
    check_graph_run(engine, stats, label)
    _check_serving_launches(launches, stats, cfg.n_layers, label)
    if stats["prefill_chunks"] != 2 or stats["prefills"] != len(FAMILY_PROMPTS) - 1:
        fail(f"{label}: {stats['prefills']} prefills and {stats['prefill_chunks']} chunks, want 15 and 2")
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    decode_tps = (generated - len(FAMILY_PROMPTS)) / stats["decode_seconds"]
    print(f"{label}: {len(FAMILY_PROMPTS)} concurrent requests, {generated} tokens in {wall:.2f} s; "
          f"{stats['prefills']} prefills, {stats['prefill_chunks']} chunks, {stats['decode_steps']} decode steps; "
          f"launches {launches}: the decode kernel at G = 71 (csrc/decode_split.cu, 9 slices of 8 query rows) "
          f"{launches['decode_attn_split']} times, the flash forward at H = 71, KH = 1 {launches['flash_fwd_wgmma']} "
          f"times", flush=True)
    reference = long_reference_check(engine, [r for r in requests if r.temperature == 0.0], label, quiet=True)
    eager = eager_check(engine, requests, label)
    graph = graph_checks(engine, requests, label)
    profiled = profile_engine(engine, label, lens=(16, 400))
    busy = profiled["decode"]["device_busy_ms"] / profiled["decode_step_ms"]
    gb_s = written["bytes"] / loads[0] / 1e9
    prefill_ms = 1e3 * stats["prefill_seconds"] / (stats["prefills"] + stats["prefill_chunks"])
    print(f"{label} [{card}]: loaded {written['bytes']} bytes in {loads[0]:.2f} s ({gb_s:.2f} GB/s), {compared} "
          f"bytes bit for bit the source's; mean prefill {prefill_ms:.1f} ms a forward; mean decode step "
          f"{step_ms:.2f} ms at up to 16 slots, decode {decode_tps:.1f} tokens/s; a full batch's step "
          f"{profiled['decode_step_ms']:.2f} ms, device busy {profiled['decode']['device_busy_ms']:.2f} ms "
          f"({100 * busy:.1f}%)", flush=True)
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    return {"bytes": written["bytes"], "write_s": write_s, "load_s": loads[0], "launches": launches, "stats": stats,
            "generated": generated, "wall_s": wall, "step_ms": step_ms, "decode_tokens_per_s": decode_tps,
            "reference": reference, "eager_sync": eager, "graph": graph, "profile": profiled, "busy_share": busy}


def families_opt_quickstart(card: str, tmp: Path) -> dict:
    """(b) The reference's quickstart: opt-125m (seed 0) written as an HF OPT
    directory, finetuned by train.main with the example's params on a
    seeded token corpus, its artifact served through serve.main --model."""
    import torch

    from substratus_tpu_torch.models import opt
    from substratus_tpu_torch.tools.ckpt_writer import write_hf
    from substratus_tpu_torch.train import main as train_main

    label = "serve-families opt-125m"
    cfg = opt.CONFIGS["opt-125m"]
    write_hf(str(tmp / "opt-125m"), opt.init_params(cfg, seed=0, device="cuda"))
    _token_corpus(tmp / "opt-data", cfg.vocab_size, 200_000)
    params_path = tmp / "opt-train.json"
    params_path.write_text(json.dumps(OPT_TRAIN_PARAMS))
    _zero_train_counts()
    t0 = time.perf_counter()
    res = train_main.run(["--model", str(tmp / "opt-125m"), "--data", str(tmp / "opt-data"), "--out",
                          str(tmp / "opt-out"), "--params", str(params_path)])
    train_s = time.perf_counter() - t0
    train_launches = _train_launches()
    n, L = len(res["losses"]), cfg.n_layers
    want = {"flash_fwd": 2 * L * n, "flash_fwd_all": 2 * L * n, "flash_bwd_dq": L * n, "flash_bwd_dq_all": L * n,
            "flash_bwd_dkv": L * n, "flash_bwd_dkv_all": L * n}
    if n != OPT_TRAIN_PARAMS["steps"] or train_launches != want or not all(map(math.isfinite, res["losses"])):
        fail(f"{label}: {n} steps, losses {res['losses']}, launches {train_launches} (want {want})")
    merged = res["merged"]
    loads, restore = timed_loads()
    try:
        server, engine, base = start_server("serve-families-opt", {"max_batch": 8},
                                            ["--model", str(tmp / "opt-out")], model=OPT_125M)
    finally:
        restore()
    requests = tee_requests(engine)
    try:
        same_state(engine.params, merged, f"{label} artifact")
        zero_counts(engine, _serving_counters())
        results, wall = run_concurrent(base, PROMPTS)
        wait_idle(engine)
        launches = _serving_launches(engine)
        stats = dict(engine.stats)
        del engine.submit
        same = eager_check(engine, requests, label, params=merged)
        reference = long_reference_check(engine, [r for r in requests if r.temperature == 0.0], label, quiet=True)
    finally:
        server.stop()
    generated = check_usage(PROMPTS, results)
    _check_serving_launches(launches, stats, L, label)
    print(f"{label} [{card}]: train.main {n} steps of batch 2 x 256 (LoRA r8) in {train_s:.1f} s, losses "
          f"{[round(x, 4) for x in res['losses']]}, launches {train_launches}; the artifact served in "
          f"{loads[0]:.2f} s of load, {generated} tokens for {len(PROMPTS)} requests in {wall:.2f} s, launches "
          f"{launches}", flush=True)
    del engine, server, res, merged
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_s": train_s, "train_launches": train_launches, "launches": launches, "stats": stats,
            "same_as_merged": same, "reference": reference, "load_s": loads[0]}


def families_falcon_lora(card: str, tmp: Path) -> dict:
    """(c) falcon-7b LoRA through train.main: the flash backward at G = 71
    (dK/dV summed over the 71 query heads of the one kv head), the loss
    finite, the merged artifact loads."""
    import torch

    from substratus_tpu_torch.models import falcon
    from substratus_tpu_torch.train import main as train_main
    from substratus_tpu_torch.train.checkpoints import load_artifact

    label = "serve-families falcon-7b LoRA"
    params = {**FALCON_TRAIN_PARAMS, "config": at_depth(FALCON_TRAIN_PARAMS["config"], FALCON_LAYERS)}
    cfg = falcon.CONFIGS[params["config"]]
    _token_corpus(tmp / "falcon-data", cfg.vocab_size, 200_000)
    params_path = tmp / "falcon-train.json"
    params_path.write_text(json.dumps(params))
    disk_room(tmp, 14 * 10**9, label)
    _zero_train_counts()
    torch.cuda.reset_peak_memory_stats()
    res = train_main.run(["--data", str(tmp / "falcon-data"), "--out", str(tmp / "falcon-out"), "--params",
                          str(params_path)])
    peak = torch.cuda.max_memory_allocated()
    train_launches = _train_launches()
    n, L = len(res["losses"]), cfg.n_layers
    want = {"flash_fwd": 2 * L * n, "flash_fwd_all": 2 * L * n, "flash_bwd_dq": L * n, "flash_bwd_dq_all": L * n,
            "flash_bwd_dkv": L * n, "flash_bwd_dkv_all": L * n}
    if n != 2 or train_launches != want or not all(map(math.isfinite, res["losses"])):
        fail(f"{label}: {n} steps, losses {res['losses']}, launches {train_launches} (want {want})")
    t0 = time.perf_counter()
    cfg2, model = load_artifact(str(tmp / "falcon-out"))
    load_s = time.perf_counter() - t0
    if cfg2 != res["cfg"] or type(model) is not falcon.Falcon:
        fail(f"{label}: the artifact loads as {type(model).__name__} {cfg2}")
    same_state(model, res["merged"], f"{label} artifact")
    print(f"{label} [{card}]: train.main 2 steps of batch 2 x 1024 (r16 on wq/wv, remat): losses {res['losses']}, "
          f"step {res['step_seconds']} s, peak {peak / 2**30:.1f} GiB, launches {train_launches}; the merged "
          f"artifact written in {res['artifact_seconds']:.1f} s, loaded in {load_s:.1f} s, bit for bit", flush=True)
    del model, res
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_launches": train_launches, "peak_bytes": peak, "artifact_load_s": load_s}


# facebook/opt-2.7b's published shape (config.json: hidden_size 2560, 32
# attention heads, so head_dim 80; ffn_dim 10240, vocabulary 50272) at 8 of
# its 32 layers (cut to keep the default run well inside its time limit) as
# overrides of opt-1.3b: the port's CONFIGS gain no entry the JAX package
# lacks. Served with falcon-7b's params, then 2 LoRA steps of 2 x 512.
OPT_2_7B_SHAPE = "dim=2560,n_heads=32,n_layers=8,hidden_dim=10240"
OPT_2_7B = ("opt-2.7b's shape at 8 layers", (2560, 8, 32, 32, 50272))
OPT_2_7B_PROMPTS = [p for p in FAMILY_PROMPTS if p[2] == 0.0][::2]  # 8 greedy prompts of 16-600 tokens
OPT_2_7B_TRAIN = {"steps": 2, "batch_size": 2, "seq_len": 512, "lora_rank": 16, "lora_alpha": 16,
                  "learning_rate": 2e-4, "save_steps": 2, "remat": True, "seed": 0}


def families_opt_2_7b(card: str, tmp: Path) -> dict:
    """(d) opt-2.7b's shape (head_dim 80, which no kernel is built for)
    written by tools/ckpt_writer.py as an HF OPT directory, served by
    serve.main --model (greedy requests, every launch through the padded
    route, the reference), its LoRA gradients through the kernels against
    the plain attention, then 2 LoRA steps through train.main."""
    import numpy as np
    import torch

    from substratus_tpu_torch.models import opt
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_cached_attention)
    from substratus_tpu_torch.tools.ckpt_writer import shape_overrides, write_hf
    from substratus_tpu_torch.train import main as train_main
    from substratus_tpu_torch.train.trainer import TrainConfig, Trainer

    label = "serve-families opt-2.7b"
    cfg = shape_overrides(opt.CONFIGS["opt-1.3b"], OPT_2_7B_SHAPE)
    if cfg.head_size != 80:
        fail(f"{label}: head_dim {cfg.head_size}, want 80")
    source = opt.init_params(cfg, seed=0, device="cuda")
    disk_room(tmp, 2 * sum(t.numel() * t.element_size() for t in source.state_dict().values()), label)
    written = write_hf(str(tmp / "opt-2.7b"), source)
    loads, restore = timed_loads()
    try:
        server, engine, base = start_server("serve-families-opt-2.7b", FAMILY_PARAMS,
                                            ["--model", str(tmp / "opt-2.7b")], model=OPT_2_7B)
    finally:
        restore()
    requests = tee_requests(engine)
    counters = (flash_attention, flash_cached_attention, decode_attention)
    try:
        same_state(engine.params, source, label)
        route = engine.attention_route()
        if "head_dim 80 padded to 128" not in route or engine.cache["k"].shape[-1] != 128:
            fail(f"{label}: the dense cache is not laid out at 128: {route}")
        zero_counts(engine, _serving_counters())
        results, wall = run_concurrent(base, OPT_2_7B_PROMPTS)
        wait_idle(engine)
        launches = _serving_launches(engine)
        padded = {c.__name__: launched(engine, c, "launches_padded") for c in counters}
        stats = dict(engine.stats)
        del engine.submit
        reference = long_reference_check(engine, requests, label, quiet=True)
    finally:
        server.stop()
    generated = check_usage(OPT_2_7B_PROMPTS, results)
    _check_serving_launches(launches, stats, cfg.n_layers, label)
    want = {"flash_attention": launches["flash_fwd"], "flash_cached_attention": launches["flash_cached"],
            "decode_attention": launches["decode_attn"]}
    if padded != want or not stats["prefill_chunks"]:
        fail(f"{label}: launches at the padded route {padded}, want every launch {want} (and a chunked prompt)")
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    print(f"{label} [{card}]: {written['bytes']} bytes loaded in {loads[0]:.2f} s; {route}; {len(results)} greedy "
          f"requests, {generated} tokens in {wall:.2f} s, mean decode step {step_ms:.2f} ms at up to 16 slots; "
          f"launches {launches}, each through the padded route {padded}", flush=True)
    del engine, server

    # Its LoRA gradients through the kernels (forward, dQ, dK/dV at the
    # padded head dim) against the plain attention, on the source weights.
    tc = TrainConfig(lora_rank=16, lora_alpha=16, learning_rate=2e-4, seed=0, remat=True)
    check = Trainer(cfg, tc, params=source)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for layer in check.lora.layers:
            for ab in layer.values():
                ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device="cuda") * 1e-2)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 512)), "weights": np.ones((2, 512), np.float32)}
    grads = grad_check(check, batch, label, twin_floor=True)
    del check, source
    gc.collect()
    torch.cuda.empty_cache()

    _token_corpus(tmp / "opt-2.7b-data", cfg.vocab_size, 200_000)
    params_path = tmp / "opt-2.7b-train.json"
    params_path.write_text(json.dumps(OPT_2_7B_TRAIN))
    _zero_train_counts()
    bwd = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    for c in bwd:
        c.launches_padded = 0
    res = train_main.run(["--model", str(tmp / "opt-2.7b"), "--data", str(tmp / "opt-2.7b-data"), "--out",
                          str(tmp / "opt-2.7b-out"), "--params", str(params_path)])
    train_launches = _train_launches()
    n, L = len(res["losses"]), cfg.n_layers
    want = {"flash_fwd": 2 * L * n, "flash_fwd_all": 2 * L * n, "flash_bwd_dq": L * n, "flash_bwd_dq_all": L * n,
            "flash_bwd_dkv": L * n, "flash_bwd_dkv_all": L * n}
    train_padded = {c.__name__: c.launches_padded for c in bwd}
    if (n != 2 or train_launches != want or not all(map(math.isfinite, res["losses"]))
            or list(train_padded.values()) != [2 * L * n, L * n, L * n]):
        fail(f"{label}: {n} LoRA steps, losses {res['losses']}, launches {train_launches} (want {want}), at the "
             f"padded route {train_padded}")
    print(f"{label} [{card}]: train.main 2 LoRA steps of 2 x 512 (r16, remat): losses {res['losses']}, step "
          f"{res['step_seconds']} s, launches {train_launches}, all padded {train_padded}", flush=True)
    shutil.rmtree(tmp / "opt-2.7b", ignore_errors=True)
    shutil.rmtree(tmp / "opt-2.7b-out", ignore_errors=True)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return {"bytes": written["bytes"], "load_s": loads[0], "route": route, "launches": launches, "padded": padded,
            "stats": stats, "step_ms": step_ms, "reference": reference, "grads": grads,
            "train_launches": train_launches, "train_padded": train_padded}


def serve_families_phase(card: str) -> dict:
    """OPT and Falcon through the entry points at full width: (a) falcon-7b
    served, (b) the opt-125m quickstart, (c) a falcon-7b LoRA step (module
    docstring). Everything written lives in a temporary directory removed
    at the end."""
    import tempfile

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_families_"))
    try:
        served = families_falcon_serve(card, tmp)
        quickstart = families_opt_quickstart(card, tmp)
        lora = families_falcon_lora(card, tmp)
        opt27 = families_opt_2_7b(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b, c = served["launches"], quickstart, lora["train_launches"]
    launches = {"flash_fwd_wgmma": a["flash_fwd_wgmma"] + b["launches"]["flash_fwd_wgmma"]
                + b["train_launches"]["flash_fwd"] + c["flash_fwd"],
                "decode_attn_split": a["decode_attn_split"] + b["launches"]["decode_attn_split"],
                "flash_cached_wgmma": a["flash_cached_wgmma"] + b["launches"]["flash_cached_wgmma"],
                "flash_bwd_dq": b["train_launches"]["flash_bwd_dq"] + c["flash_bwd_dq"],
                "flash_bwd_dkv": b["train_launches"]["flash_bwd_dkv"] + c["flash_bwd_dkv"]}
    print(f"serve-families: launches over its legs (a)-(c) {launches}; (d), opt-2.7b's shape, all padded: "
          f"serving {opt27['padded']}, training {opt27['train_padded']}", flush=True)
    return {"falcon_serve": served, "opt_quickstart": quickstart, "falcon_lora": lora, "opt_2_7b": opt27,
            "launches": launches}


# --- serve-batchgen: the batch-generation example at llama2-7b width ---------

# examples/batch-generation/batchgen-server.yaml's params (chips: 1):
# weight-only int8, 16 slots, 128 tokens a record unless it sets its own.
BATCHGEN_PARAMS = {"quantize": "int8", "max_batch": 16}
BATCHGEN_MAX_TOKENS = 128
BATCHGEN_KILL_AT = 16  # leg (b): durable records before the SIGKILL
BATCHGEN_REFERENCE = 8  # greedy records held by the single-shot reference in legs (a) and (c)
BATCHGEN_TEXT_LENS = (16, 40, 100, 200, 400, 700, 1000)  # byte-tokens (1 + bytes) of the text prompts, in turn
# The phase's depth: llama2-7b's width at 2 of its 32 layers (cut to 16 so
# that the default run stayed under 1100 s with the observability legs, to 8
# once serve-disagg joined it, to 4 once serve-gang's llama2-70b leg did,
# and to 2 once serve-gang's legs (f)-(h) went through serve.main).
BATCHGEN_LAYERS = 2


def batchgen_records() -> list:
    """The manifest: 48 text prompts of 16 to 1000 byte-tokens (mixed; a
    few with their own budget of 32, three sampled at 0.8), 14 records of
    token ids (8-307), one with no prompt (written once as "invalid") and
    one naming an adapter (an "error" record: the port has no adapter
    store). 64 records, the two odd ones at lines 20 and 41."""
    rng = random.Random(16)
    recs = []
    for i in range(48):
        rec = {"id": f"text-{i}", "prompt": _long_text(BATCHGEN_TEXT_LENS[i % 7] - 1, 300 + i)}
        if i % 12 == 5:
            rec["max_tokens"] = 32
        if i % 16 == 7:
            rec["temperature"] = 0.8
        recs.append(rec)
    recs += [{"id": f"tokens-{i}", "tokens": [rng.randrange(3, 32000) for _ in range(8 + 23 * i)]} for i in range(14)]
    recs.insert(20, {"id": "no-prompt"})
    recs.insert(41, {"id": "adapter", "tokens": [1, 2, 3, 4], "model": "t0"})
    return recs


class BatchgenChild:
    """serve.batchgen in a child process, its output in OUT_DIR/<name>.log;
    /metrics of its progress server read every half second while it runs
    (the last reading is kept: the child exits when the manifest drains)."""

    def __init__(self, name: str, model: Path, params: dict, env: dict):
        OUT_DIR.mkdir(exist_ok=True)
        params_path = OUT_DIR / f"chip_smoke_params_{name}.json"
        params_path.write_text(json.dumps(params))
        self.log = (OUT_DIR / f"{name}.log").open("w")
        self.lines, self.metrics = [], None
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", "substratus_tpu_torch.serve.batchgen", "--model", str(model),
                                      "--params", str(params_path)], cwd=Path(__file__).resolve().parent, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.port = None
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.poller = threading.Thread(target=self._poll, daemon=True)
        self.reader.start()
        self.poller.start()

    def _read(self):
        for line in self.proc.stdout:
            self.log.write(line)
            self.log.flush()
            self.lines.append(line)
            if line.startswith("batchgen progress on :"):
                self.port = int(line.rsplit(":", 1)[1])

    def _poll(self):
        while self.proc.poll() is None:
            if self.port is not None:
                try:
                    status, _, text = http(f"http://127.0.0.1:{self.port}", "/metrics", timeout=5)
                    if status == 200:
                        self.metrics = text
                except OSError:  # the child is exiting
                    pass
            time.sleep(0.5)

    def line(self, prefix: str) -> str:
        return next((ln for ln in self.lines if ln.startswith(prefix)), "")

    def finish(self, label: str, timeout: float = 900) -> dict:
        """Wait for the run to end; its summary (the last line)."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            fail(f"{label}: the child did not finish in {timeout} s: {''.join(self.lines[-20:])}")
        self.reader.join(timeout=10)
        self.poller.join(timeout=10)
        self.log.close()
        if rc != 0:
            fail(f"{label}: the child exited {rc}: {''.join(self.lines[-20:])}")
        return json.loads(self.lines[-1])

    def kill(self):
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=60)
        self.reader.join(timeout=10)
        self.poller.join(timeout=10)
        self.log.close()


def batchgen_shards(out: Path) -> dict:
    """{index: [output records]} over every shard, torn lines skipped."""
    got = {}
    for path in sorted(out.glob("shard-*.jsonl")):
        for line in path.read_text().splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            got.setdefault(rec["index"], []).append(rec)
    return got


def phase_mean(metrics: str, phase: str):
    """The mean of substratus_serve_phase_seconds{phase=...} in a /metrics text."""
    def value(kind):
        for line in metrics.splitlines():
            if line.startswith(f'substratus_serve_phase_seconds_{kind}{{phase="{phase}"}}'):
                return float(line.rsplit(" ", 1)[1])
        return None

    total, count = value("sum"), value("count")
    return total / count if total is not None and count else None


def check_batchgen_output(got: dict, recs: list, label: str) -> None:
    """Every manifest index exactly once; the no-prompt record "invalid",
    the adapter record "error", every other ok with its budget kept."""
    if sorted(got) != list(range(len(recs))) or any(len(rs) != 1 for rs in got.values()):
        dup = sorted(i for i, rs in got.items() if len(rs) != 1)
        fail(f"{label}: indices {sorted(set(range(len(recs))) - set(got))} missing, {dup} more than once")
    for i, rec in enumerate(recs):
        out = got[i][0]
        if rec["id"] == "no-prompt":
            ok = out["finish_reason"].startswith("invalid") and out["tokens"] == []
        elif rec["id"] == "adapter":
            ok = out["finish_reason"] == "error" and out["tokens"] == [] and out["model"] == "t0"
        else:
            budget = rec.get("max_tokens", BATCHGEN_MAX_TOKENS)
            ok = (out["finish_reason"] in ("stop", "length") and 1 <= out["gen_tokens"] <= budget
                  and out["gen_tokens"] == len(out["tokens"]))
        if not ok or out["id"] != rec["id"]:
            fail(f"{label}: record {i} ({rec['id']}) written as {out}")


def batchgen_reference(engine, recs: list, got: dict, label: str) -> dict:
    """BATCHGEN_REFERENCE greedy ok records of several prompt lengths held
    by long_reference_check on `engine`'s weights (the same int8 weights
    the child quantized): each token within 5% of the logit scale of the
    single-shot forward's best logit."""
    from types import SimpleNamespace

    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    greedy = [i for i, r in enumerate(recs) if "model" not in r and r.get("temperature", 0.0) == 0.0
              and ("tokens" in r or "prompt" in r)]
    picked = greedy[:: max(1, len(greedy) // BATCHGEN_REFERENCE)][:BATCHGEN_REFERENCE]
    shims = [SimpleNamespace(prompt_tokens=recs[i].get("tokens") or tok.encode(recs[i]["prompt"]),
                             out=SimpleNamespace(tokens=got[i][0]["tokens"])) for i in picked]
    return long_reference_check(engine, shims, label, quiet=True)


def serve_batchgen_phase(card: str) -> dict:
    """The batch-generation example at llama2-7b width (BATCHGEN_LAYERS
    deep): its params through
    python -m substratus_tpu_torch.serve.batchgen as a child on a seeded HF
    directory (leg a), a SIGKILL and a rerun (leg b), the same manifest on
    the dense layout in-process (leg c), and one replayed step of the
    example's paged int8 engine under the profiler."""
    import os
    import tempfile

    import torch

    from substratus_tpu_torch.load.manifest import completed_indices, list_shards, write_manifest
    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_attention
    from substratus_tpu_torch.serve.batchgen import BatchGenDriver
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.serve.main import load_model
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    label = "serve-batchgen"
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_batchgen_"))
    env = {**os.environ,
           "PYTHONPATH": str(Path(__file__).resolve().parent) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    try:
        cfg = llama.CONFIGS["llama2-7b"].replace(n_layers=BATCHGEN_LAYERS)
        source = llama.init_params(cfg, seed=0, device="cuda")
        disk_room(tmp, 13_500_000_000 * BATCHGEN_LAYERS // 32, label)
        t0 = time.perf_counter()
        written = write_hf(str(tmp / "llama2-7b"), source)
        print(f"{label}: llama2-7b at {BATCHGEN_LAYERS} of its 32 layers (seed 0, bf16) written as "
              f"{len(written['files'])} safetensors shards, {written['bytes']} bytes in {time.perf_counter() - t0:.1f} s",
              flush=True)
        del source
        gc.collect()
        torch.cuda.empty_cache()
        recs = batchgen_records()
        man = tmp / "prompts.jsonl"
        write_manifest(str(man), recs)

        def params(out: Path) -> dict:
            return dict(BATCHGEN_PARAMS, batchGenerate={"manifest": str(man), "output": str(out),
                                                        "maxTokens": BATCHGEN_MAX_TOKENS, "progressPort": 0})

        # (a) The example as written.
        child = BatchgenChild("serve_batchgen_a", tmp / "llama2-7b", params(tmp / "out-a"), env)
        summary = child.finish(f"{label} (a)")
        got_a = batchgen_shards(tmp / "out-a")
        check_batchgen_output(got_a, recs, f"{label} (a)")
        if (summary["written"], summary["ok"], summary["errors"], summary["resumed"]) != (64, 62, 2, 0):
            fail(f"{label} (a): summary {summary}")
        startup = child.line("batchgen: ")
        weights = [int(w) for w in startup.split("(")[1].split(")")[0].replace(",", "").split() if w.isdigit()]
        decode_s = phase_mean(child.metrics or "", "decode")
        if child.metrics is None or decode_s is None or "int8 weights" not in startup or "paged kv" not in startup:
            fail(f"{label} (a): startup {startup!r}, /metrics read {child.metrics is not None}")
        print(f"{label} (a) [{card}]: {startup.strip()}; {summary['written']} records ({summary['ok']} ok, "
              f"{summary['errors']} errors) in {summary['wall_s']} s, {summary['gen_tokens']} generated tokens, "
              f"{summary['gen_tok_s']} tokens/s, slot occupancy {summary['slot_occupancy']}; mean decode phase "
              f"{1e3 * decode_s:.2f} ms (/metrics)", flush=True)
        leg_a = {"summary": summary, "startup": startup.strip(), "weight_bytes": weights[0],
                 "peak_bytes": weights[1], "decode_phase_ms": 1e3 * decode_s}

        # (b) A SIGKILL once BATCHGEN_KILL_AT records are durable, a torn
        # line appended to the last shard, the same command again.
        out_b = tmp / "out-b"
        child = BatchgenChild("serve_batchgen_b1", tmp / "llama2-7b", params(out_b), env)
        deadline = time.perf_counter() + 600
        while len(completed_indices(str(out_b))) < BATCHGEN_KILL_AT:
            if child.proc.poll() is not None or time.perf_counter() > deadline:
                fail(f"{label} (b): the child ended before {BATCHGEN_KILL_AT} records were durable")
            time.sleep(0.05)
        child.kill()
        durable = completed_indices(str(out_b))
        if len(durable) >= len(recs):
            fail(f"{label} (b): the kill landed after the run")
        last = Path(list_shards(str(out_b))[-1])
        torn = min(set(range(len(recs))) - durable)
        with last.open("a") as f:
            f.write(json.dumps({"index": torn, "tokens": [1, 2, 3]})[:20])
        shards_before = len(list_shards(str(out_b)))
        child = BatchgenChild("serve_batchgen_b2", tmp / "llama2-7b", params(out_b), env)
        again = child.finish(f"{label} (b)")
        got_b = batchgen_shards(out_b)
        check_batchgen_output(got_b, recs, f"{label} (b)")
        fresh = {json.loads(line)["index"] for line in Path(list_shards(str(out_b))[-1]).read_text().splitlines()}
        if (again["resumed"] != len(durable) or again["written"] != len(recs) - len(durable)
                or len(list_shards(str(out_b))) != shards_before + 1 or fresh != set(range(len(recs))) - durable):
            fail(f"{label} (b): {len(durable)} durable at the kill, rerun {again}, shards {list_shards(str(out_b))}")
        print(f"{label} (b): killed with {len(durable)} records durable, a torn line for index {torn} appended to "
              f"{last.name}; the rerun resumed {again['resumed']} and wrote {again['written']} into a fresh shard: "
              f"every index once over {len(list_shards(str(out_b)))} shards", flush=True)
        leg_b = {"durable_at_kill": len(durable), "rerun": again}

        # (c) The same manifest and int8 weights in-process on the dense
        # layout (the decode kernel, the flash forward and the cached flash
        # under the pull source and the decode graph); before it, one
        # replayed step of the example's own paged engine under the profiler.
        cfg, params_c, tok, _, _, _ = load_model(str(tmp / "llama2-7b"), None, {}, torch.device("cuda"), "int8")
        engine = Engine(cfg, params_c, EngineConfig(max_batch=16, max_seq_len=1024, eos_token_id=tok.eos_id))
        if not engine.paged:
            fail(f"{label}: the example's engine is not on the paged pool")
        profiled = profile_engine(engine, f"{label} paged int8", lens=(16, 400), fill=100, steps=8)
        step = profiled["decode"]
        print(f"{label} paged int8 [{card}]: one replayed step at B={profiled['batch']}: "
              f"{profiled['decode_step_ms']:.2f} ms, device busy {step['device_busy_ms']:.2f} ms: copies "
              f"{step['copy_ms']:.2f} ms (the int8 weights' bf16 copies among them), GEMMs {step['gemm_ms']:.2f}, "
              f"the gather {step['gather_ms']:.2f}", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        engine = Engine(cfg, params_c, EngineConfig(max_batch=16, max_seq_len=1024, eos_token_id=tok.eos_id,
                                                    kv_layout="dense"))
        engine.start()
        engine.generate([256, 1, 2, 3], max_tokens=2)  # the warm-up: the decode graph captured
        wait_idle(engine)
        counters = (flash_attention, flash_cached_attention, decode_attention)
        zero_counts(engine, counters)
        try:
            summary_c = BatchGenDriver([engine], str(man), str(tmp / "out-c"), tokenizer=ByteTokenizer(),
                                       max_tokens=BATCHGEN_MAX_TOKENS).run()
            wait_idle(engine)
        finally:
            engine.stop()
        stats = dict(engine.stats)
        launches = {c.__name__: launched(engine, c) for c in counters}
        got_c = batchgen_shards(tmp / "out-c")
        check_batchgen_output(got_c, recs, f"{label} (c)")
        L = cfg.n_layers
        want = {"flash_attention": L * stats["prefills"], "flash_cached_attention": L * stats["prefill_chunks"],
                "decode_attention": L * stats["decode_steps"]}
        if launches != want or not all(want.values()) or stats["graph_replays"] != stats["decode_steps"]:
            fail(f"{label} (c): launches {launches}, want {want} (stats {stats})")
        same = sum(got_c[i][0]["tokens"] == got_a[i][0]["tokens"] for i in got_a)
        ref_a = batchgen_reference(engine, recs, got_a, f"{label} (a)")
        ref_c = batchgen_reference(engine, recs, got_c, f"{label} (c)")
        step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
        print(f"{label} (c) [{card}]: dense, {summary_c['written']} records in {summary_c['wall_s']} s, "
              f"{summary_c['gen_tok_s']} tokens/s (leg (a), paged: {summary['gen_tok_s']}), slot occupancy "
              f"{summary_c['slot_occupancy']}, mean step {step_ms:.2f} ms; launches with replays {launches}; "
              f"{same} of 64 records token for token leg (a)'s", flush=True)
        del engine, params_c
        gc.collect()
        torch.cuda.empty_cache()
        return {"a": leg_a, "b": leg_b, "c": {"summary": summary_c, "launches": launches, "stats": stats,
                                               "step_ms": step_ms, "same_as_a": same},
                "reference_a": ref_a, "reference_c": ref_c, "profile_paged": profiled}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- serve-adapters: multi-tenant LoRA adapters at llama2-7b width -------------

ADAPTER_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# serve-adapters' depth for legs (a) and (b): llama2-7b's width at 4 of its
# 32 layers, cut so that the default run stays within its time limit (16
# once serve-disagg joined it, 8 once serve-gang did, 4 to keep it well
# inside; every check as at full depth).
ADAPTERS_LAYERS = 4
ADAPTERS_MODEL = (f"llama2-7b at {ADAPTERS_LAYERS} layers", (4096, ADAPTERS_LAYERS, 32, 32, 32000))
# The four tenants, as the store lists them (sorted): the first two are
# preloaded into the capacity-2 store, the others hot-load and evict.
# (id, rank, alpha, targets); "trained" comes from one train.main LoRA step.
ADAPTER_SPECS = (("lora-a", 16, 32.0, ADAPTER_TARGETS), ("lora-b", 16, 32.0, ADAPTER_TARGETS),
                 ("lora-qv", 8, 16.0, ("wq", "wv")))
ADAPTER_IDS = ("lora-a", "lora-b", "lora-qv", "trained")
ADAPTER_TRAIN_PARAMS = {"steps": 1, "batch_size": 1, "seq_len": 256, "lora_rank": 16, "lora_alpha": 32,
                        "learning_rate": 1e-3, "warmup_steps": 0, "save_steps": 1000}
# Leg (a): serve.main's default layout for llama (the paged pool), bf16;
# leg (b): the dense cache with int4 weights, the int8 cache and the fused
# decode (serve-int4's stack). Both: the adapters directory at capacity 2.
ADAPTER_PARAMS = {"max_batch": 8, "max_seq_len": 1024, "max_prefill_len": 512, "adapters": {"capacity": 2}}
ADAPTER_INT4_PARAMS = dict(ADAPTER_PARAMS, max_seq_len=2048, kv_layout="dense", quantize="int4",
                           kv_cache_dtype="int8", decode_attn_impl="fused")
# 16 greedy requests of 18-393 tokens over the base and the four tenants in
# turn (a tag first, so no two prompts share a 16-token page); leg (b) adds
# one of 1308 tokens under the trained adapter (3 chunks of 512).
ADAPTER_PROMPTS = [(f"[{i:02d}] " + _long_text(12 + 25 * i, 40 + i), 16, ((None,) + ADAPTER_IDS)[i % 5])
                   for i in range(16)]
ADAPTER_LONG = ("[long] " + _long_text(1300, 60), 16, "trained")
# serve-adapters (c): a llama at gemma-7b's attention widths (16 heads of
# 256 on 16 kv heads, hidden 3072, FFN 24576), its depth cut to 4 layers.
GEMMA_HEADS = dict(vocab_size=32000, dim=3072, n_layers=4, n_heads=16, n_kv_heads=16, head_dim=256,
                   hidden_dim=24576, max_seq_len=8192)


def random_lora(cfg, seed: int, rank: int, alpha: float, targets) -> dict:
    """{name: {"a": [L, in, r], "b": [L, r, *out]}} float32 numpy from a
    seed: A ~ N(0, 1/in), B random too (so no delta is zero), scaled so a
    delta's norm is about 0.3 of its projection's."""
    import numpy as np

    from substratus_tpu_torch.serve.adapters import _target_shapes

    rng = np.random.default_rng(seed)
    sigma = 0.3 / ((alpha / rank) * rank**0.5)
    return {name: {"a": rng.standard_normal((cfg.n_layers, ind, rank), dtype=np.float32) * np.float32(ind**-0.5),
                   "b": rng.standard_normal((cfg.n_layers, rank) + out, dtype=np.float32) * np.float32(sigma)}
            for name, (ind, out) in _target_shapes(cfg, targets).items()}


def plain_lora(layers: dict, scale: float, device, dtype) -> dict:
    """An artifact's tree as the models' forward takes it for one request:
    {"layers": [{name: {"a": [in, r], "b": [r, *out]}}], "scale"} in the
    model's dtype, for the plain (non-indexed) lora_delta."""
    import torch

    n = next(iter(layers.values()))["a"].shape[0]
    return {"layers": [{name: {k: torch.from_numpy(ab[k][i]).to(device=device, dtype=dtype) for k in ("a", "b")}
                        for name, ab in layers.items()} for i in range(n)], "scale": scale}


def adapter_reference(engine, requests, trees: dict, label: str) -> dict:
    """Each served greedy token against one teacher-forced single-shot
    forward over prompt + served tokens on the engine's weights with the
    request's adapter applied by the plain lora_delta (none for the base):
    its argmax, or a near-tie within 5% of the logit scale (reported)."""
    import torch

    agree = total = 0
    worst = (0.0, 1.0)
    for req in requests:
        prompt, toks = engine.clipped_prompt(req.prompt_tokens), req.out.tokens
        seq = torch.tensor([prompt + toks[:-1]], device=engine.device)
        with torch.inference_mode():
            logits, _ = engine.model.forward(engine.params, seq, engine.cfg, lora=trees.get(req.adapter))
        logits = logits[0, len(prompt) - 1:]
        if not torch.isfinite(logits).all():
            fail(f"{label}: non-finite reference logits ({req.adapter})")
        scale = logits.abs().max().item()
        gaps = logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]
        agree += sum(int(logits[i].argmax()) == t for i, t in enumerate(toks))
        total += len(toks)
        if gaps.max().item() / scale > worst[0] / worst[1]:
            worst = (gaps.max().item(), scale)
        if not toks or gaps.max().item() > 0.05 * scale:
            fail(f"{label}: a served token of a {len(prompt)}-token prompt under {req.adapter} departs from the "
                 f"single-shot reference by more than a near-tie: gap {gaps.max().item():.4g} at scale {scale:.4g}")
    print(f"{label} reference: {agree}/{total} served greedy tokens of {len(requests)} requests (base and tenants) "
          f"are the argmax of the single-shot forward with the request's adapter applied by the plain lora_delta; "
          f"the rest near-ties, the largest gap {worst[0]:.4g} at logit scale {worst[1]:.4g}", flush=True)
    return {"argmax_agree": agree, "tokens": total, "max_gap": worst[0], "logit_scale": worst[1]}


def post_tenants(base: str, prompts) -> tuple:
    """POST every (text, max_tokens, tenant) at once, greedy, each with its
    tenant in the `model` field (none for the base); ([(status, body)],
    wall seconds)."""
    results = [None] * len(prompts)

    def run(i, text, n, tenant):
        body = {"prompt": text, "max_tokens": n, "temperature": 0.0, **({"model": tenant} if tenant else {})}
        try:
            results[i] = post(base, body)[:2]
        except Exception as e:  # reported below as a failed request
            results[i] = (None, repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i, *p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def engine_tokens(engine, requests, adapters: bool) -> list:
    """The requests served again, all submitted at once, through `engine`
    (started here and stopped): [(tokens, finish)], greedy."""
    from substratus_tpu_torch.serve.engine import Request

    engine.start()
    try:
        reqs = [engine.submit(Request(list(r.prompt_tokens), max_tokens=r.max_tokens, temperature=0.0,
                                      adapter=r.adapter if adapters else None)) for r in requests]
        outs = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=600)) is not None:
                toks.append(tok)
            outs.append((toks, req.finish_reason))
        return outs
    finally:
        engine.stop()


def steady_step_ms(engine, tenants, label: str) -> float:
    """Host clock of 16 overlapped steps (graph replays) with every slot
    filled by 100-token prompts under `tenants` (one a slot), on a stopped
    engine driven by hand; the slots (and pins) released after."""
    import torch

    from substratus_tpu_torch.serve.engine import Request

    b = engine.ec.max_batch
    for i in range(b):
        engine.queue.put(Request([256] + [65 + i] * 99, max_tokens=10_000, adapter=tenants[i % len(tenants)]))
    while not engine.active.all():
        if engine._admit() == 0:
            fail(f"{label}: admission failed")
    for _ in range(4):
        engine._step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        engine._step()
    engine._flush()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 16
    for slot in range(b):
        engine._release_slot(slot)
    return ms


def adapter_counts() -> dict:
    from substratus_tpu_torch.observability.metrics import METRICS

    return {k: METRICS.get(f"substratus_serve_adapter_{k}_total") or 0 for k in ("cache_hits", "cache_misses",
                                                                                   "evictions")}


def adapters_leg(label: str, params: dict, prompts, model_dir: Path, adapters_dir: Path, trees_of, card: str,
                 merged_tenant=None) -> dict:
    """serve.main --model <the seeded HF dir> --adapters-dir <the four
    tenants> with `params` (capacity 2): the prompts at once over HTTP, then
    the checks: usage; the store's counts; each kernel's launches (int4:
    by design against the forwards); every token by the adapter reference;
    the base rows an engine with no store's, token for token; the graph
    engine's tokens the eager synchronous step's (eager_check, with the
    store); for `merged_tenant` its tokens an engine on merge_lora(base,
    adapter)'s (a first difference a near-tie); the step with and without
    the store at full batch."""
    import torch

    from substratus_tpu_torch.serve.engine import Engine
    from substratus_tpu_torch.train.lora import LoraAdapters, merge_lora

    gc.collect()
    torch.cuda.empty_cache()
    server, engine, base = start_server(label, params, ("--model", str(model_dir), "--adapters-dir",
                                                        str(adapters_dir)), model=ADAPTERS_MODEL)
    store = engine.adapters
    if store is None or store.capacity != 2 or store.loaded_ids() != list(ADAPTER_IDS[:2]):
        fail(f"{label}: the store is {store and store.snapshot()}, want capacity 2 with {ADAPTER_IDS[:2]} preloaded")
    trees = trees_of(engine)
    counters = int4_counters()
    requests = tee_requests(engine)
    try:
        zero_counts(engine, counters.values())
        before_store, before_metrics = dict(store.stats), adapter_counts()
        results, wall = post_tenants(base, prompts)
        wait_idle(engine)
        stats = dict(engine.stats)
        launches = int4_launches(engine, counters)
        store_moved = {k: store.stats[k] - before_store[k] for k in store.stats}
        metrics_moved = adapter_counts()
        metrics_moved = {k: metrics_moved[k] - before_metrics[k] for k in metrics_moved}
        del engine.submit
    finally:
        server.stop()
    for (text, n, tenant), (status, body) in zip(prompts, results):
        usage = body.get("usage") if status == 200 else None
        if status != 200 or usage["prompt_tokens"] != len(text.encode()) + 1 or not 1 <= usage["completion_tokens"] <= n:
            fail(f"{label}: a request under {tenant}: {status} {body}")
    tenants = sum(t is not None for _, _, t in prompts)
    # What the traffic implies: every tenant request pinned its adapter
    # once, a hit or a hot load; the store starts full, so every hot load
    # evicts the least recently used unpinned tenant (hits + evictions =
    # tenant requests); the two tenants not preloaded load at least once
    # each; a miss is also counted for each admission attempt that found
    # every slot pinned and waited (the JAX store's count: misses -
    # evictions are those waits); the registry moves with the store.
    loads = store_moved["evictions"]
    if (stats["adapter_requests"] != tenants or store_moved["hits"] + loads != tenants or loads < 2
            or store_moved["misses"] < loads
            or metrics_moved != {"cache_hits": store_moved["hits"], "cache_misses": store_moved["misses"],
                                 "evictions": store_moved["evictions"]} or len(store.loaded_ids()) != 2):
        fail(f"{label}: {tenants} tenant requests, stats {stats['adapter_requests']}, store {store_moved}, "
             f"registry {metrics_moved}, resident {store.loaded_ids()}")
    if params.get("quantize") == "int4":
        check_int4_launches(engine, stats, launches, [len(text.encode()) + 1 for text, _, _ in prompts], label)
    elif any(launches[k] for k in ("flash_fwd", "flash_cached", "decode_attn", "fused_decode", "q4_matmul_total")):
        fail(f"{label}: the paged bf16 path launched an attention or int4 kernel: {launches}")
    check_graph_run(engine, stats, label)
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    print(f"{label} [{card}]: {len(prompts)} concurrent requests ({tenants} under 4 tenants, the rest the base) in "
          f"{wall:.2f} s; {stats['prefills']} prefills, {stats['prefill_chunks']} chunks, {stats['decode_steps']} "
          f"decode steps, mean step {step_ms:.2f} ms; the store: {store_moved['hits']} hits, {loads} hot loads "
          f"({loads} evictions), {store_moved['misses'] - loads} admissions waiting for a slot ({store_moved['misses']} "
          f"misses), resident {store.loaded_ids()}; launches "
          f"{launches}", flush=True)
    reference = adapter_reference(engine, requests, trees, label)

    # The base rows: an engine with no store, the served engine's knobs and weights.
    bare = Engine(engine.cfg, engine.params, engine.ec, device=engine.device, model=engine.model)
    base_reqs = [r for r in requests if r.adapter is None]
    got = engine_tokens(bare, base_reqs, adapters=False)
    if got != [(r.out.tokens, r.finish_reason) for r in base_reqs]:
        fail(f"{label}: the base rows differ from an engine with no store: {got} against "
             f"{[r.out.tokens for r in base_reqs]}")
    print(f"{label}: all {len(base_reqs)} base requests token for token an engine with no store (the identity slot "
          "adds exactly nothing)", flush=True)
    eager = eager_check(engine, requests, label)
    merged = None
    if merged_tenant is not None:
        tree = trees[merged_tenant]
        mod = LoraAdapters([{n: dict(ab) for n, ab in layer.items()} for layer in tree["layers"]])
        twin = Engine(engine.cfg, merge_lora(engine.params, mod, tree["scale"]), engine.ec, device=engine.device,
                      model=engine.model)
        mine = [r for r in requests if r.adapter == merged_tenant]
        outs = engine_tokens(twin, mine, adapters=False)
        identical, diffs = 0, []
        for req, (toks, _) in zip(mine, outs):
            a = req.out.tokens
            if a == toks:
                identical += 1
                continue
            i = next((j for j, (x, y) in enumerate(zip(a, toks)) if x != y), min(len(a), len(toks)))
            pick = [t[i] if i < len(t) else engine.ec.eos_token_id for t in (a, toks)]
            prompt = engine.clipped_prompt(req.prompt_tokens)
            with torch.inference_mode():
                logits, _ = twin.model.forward(twin.params, torch.tensor([prompt + a[:i]], device=engine.device),
                                               twin.cfg)
            row = logits[0, -1]
            gaps = [(row.max() - row[t]).item() for t in pick]
            diffs.append((i, [round(g, 4) for g in gaps]))
            if max(gaps) > 0.05 * row.abs().max().item():
                fail(f"{label}: {merged_tenant}'s tokens depart from the merged engine's at {i} by more than a "
                     f"near-tie: {gaps}")
        print(f"{label}: {identical} of {len(mine)} {merged_tenant} requests token for token an engine on "
              f"merge_lora(base, {merged_tenant})" + (f"; the others first differ at a near-tie: {diffs}" if diffs
                                                      else ""), flush=True)
        merged = {"identical": identical, "requests": len(mine), "differ": diffs}
        del twin
        gc.collect()
        torch.cuda.empty_cache()
    # The step at full batch with the store (two tenants and the base) and
    # without it (the engine of the base rows), in turns.
    with_store = steady_step_ms(engine, ("lora-a", "lora-b", None, None), label)
    without = steady_step_ms(bare, (None,), label)
    with_store2 = steady_step_ms(engine, ("lora-a", "lora-b", None, None), label)
    without2 = steady_step_ms(bare, (None,), label)
    print(f"{label} [{card}]: a replayed step at B={engine.ec.max_batch} with the store (7 x 2 products a layer "
          f"gathered per row) {with_store:.2f} / {with_store2:.2f} ms, without {without:.2f} / {without2:.2f} ms, "
          f"in turns", flush=True)
    del bare
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "stats": stats, "wall_s": wall, "store": store_moved, "reference": reference,
            "eager_sync": eager, "merged": merged, "step_ms": step_ms,
            "step_with_store_ms": [with_store, with_store2], "step_without_store_ms": [without, without2],
            "engine": engine}


def gemma_heads_leg(card: str) -> dict:
    """(c) The kernels at head_dim 256 on a served and trained path: a llama
    at gemma-7b's attention widths (4 layers, seed 0, bf16) on the dense
    cache with a store of two tenants (rank 16 on every target), twice:
    the decode kernel over a bf16 cache, then the fused decode over an int8
    cache; 6 greedy requests each (one of 700 tokens: 2 chunks), every
    token by the adapter reference, each kernel's launches 4 x prefills,
    chunks and decode steps (replays included), of the design at 256; then
    one LoRA step (r16 on wq/wv, batch 2 x 512) through the Trainer: dQ
    and dK/dV 4 launches each, of the mma design."""
    import numpy as np
    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.ops import flash_attention as fa
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention
    from substratus_tpu_torch.serve.adapters import AdapterStore
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
    from substratus_tpu_torch.train.trainer import TrainConfig, Trainer

    label = "serve-adapters (c)"
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.LlamaConfig(**GEMMA_HEADS)
    params = llama.init_params(cfg, seed=0, device="cuda")
    loras = {f"g{i}": (random_lora(cfg, 70 + i, 16, 32.0, ADAPTER_TARGETS), 2.0) for i in range(2)}
    trees = {aid: plain_lora(layers, scale, "cuda", cfg.dtype) for aid, (layers, scale) in loras.items()}
    prompts = [[(37 * i + j) % 30000 + 1 for j in range(n)] for i, n in enumerate((12, 100, 700, 40, 260, 33))]
    tenants = [None, "g0", "g1", "g0", None, "g1"]
    counters = (fa.flash_attention, fa.flash_cached_attention, decode_attention, fused_decode_attention)
    out = {"launches": {"flash_fwd_d256": 0}, "reference": []}
    for cache, decode in (("model", "kernel"), ("int8", "fused")):
        store = AdapterStore(cfg, capacity=2, rank=16, targets=ADAPTER_TARGETS, device="cuda")
        for aid, (layers, scale) in loras.items():
            store.install(aid, layers, scale)
        engine = Engine(cfg.replace(decode_attn_impl=decode), params,
                        EngineConfig(max_batch=8, max_seq_len=1024, max_prefill_len=512, kv_layout="dense",
                                     kv_cache_dtype=cache, eos_token_id=-1), adapters=store)
        engine.start()
        engine.generate([1, 2, 3], max_tokens=2)  # the warm-up: the decode graph captured
        wait_idle(engine)
        zero_counts(engine, counters)
        requests = tee_requests(engine)
        try:
            reqs = [engine.submit(Request(list(p), max_tokens=16, temperature=0.0, adapter=a))
                    for p, a in zip(prompts, tenants)]
            for r in reqs:
                while r.out.get(timeout=600) is not None:
                    pass
            wait_idle(engine)
        finally:
            engine.stop()
        del engine.submit
        stats = dict(engine.stats)
        step = {c.__name__: {k: launched(engine, c, k) for k in vars(c) if k.startswith("launches")}
                for c in counters}
        L = cfg.n_layers
        attn = "decode_attention" if decode == "kernel" else "fused_decode_attention"
        want = {"flash_attention": L * stats["prefills"], "flash_cached_attention": L * stats["prefill_chunks"],
                attn: L * stats["decode_steps"]}
        designs = {"flash_attention": "mma", "flash_cached_attention": "mma", attn: "rows"}
        if (any(step[n]["launches"] != w or step[n][f"launches_{designs[n]}"] != w or step[n]["launches_padded"]
                for n, w in want.items()) or not all(want.values())
                or step["decode_attention" if decode == "fused" else "fused_decode_attention"]["launches"]):
            fail(f"{label} {cache} cache: launches {step}, want {want} of the designs {designs}; stats {stats}")
        ref = adapter_reference(engine, requests, trees, f"{label} {cache} cache")
        out["launches"]["flash_fwd_d256"] += want["flash_attention"]
        out["launches"]["flash_cached_d256" if cache == "model" else "flash_cached_int8_d256"] = \
            want["flash_cached_attention"]
        out["launches"]["decode_attn_d256" if decode == "kernel" else "fused_decode_d256"] = want[attn]
        out["reference"].append(ref)
        print(f"{label} [{card}]: gemma-7b's heads (16 x 256), {L} layers, {cache} cache, decode_attn_impl {decode}: "
              f"{len(prompts)} requests under 2 tenants and the base; {stats['prefills']} prefills, "
              f"{stats['prefill_chunks']} chunks, {stats['decode_steps']} decode steps; launches with replays "
              f"{want} (designs {designs}), mean step {1e3 * stats['decode_seconds'] / stats['decode_steps']:.2f} ms",
              flush=True)
        del engine, store
        gc.collect()
    trainer = Trainer(cfg, TrainConfig(lora_rank=16, lora_alpha=32, learning_rate=1e-3, warmup_steps=0,
                                       total_steps=10, remat=False), params=params)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(1, 30000, (2, 512)).astype(np.int32), "weights": np.ones((2, 512), np.float32)}
    bwd = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for c in bwd + (fa.flash_attention,):
        for k in [k for k in vars(c) if k.startswith("launches")]:
            setattr(c, k, 0)
    loss = trainer.train_step(batch)
    torch.cuda.synchronize()
    got = {c.__name__: {k: getattr(c, k) for k in vars(c) if k.startswith("launches")} for c in bwd}
    if (not np.isfinite(loss) or any(g["launches"] != cfg.n_layers or g["launches_mma"] != cfg.n_layers
                                     for g in got.values())):
        fail(f"{label}: a LoRA step at head_dim 256: loss {loss}, backward launches {got}")
    out["launches"].update(flash_bwd_dq_d256=cfg.n_layers, flash_bwd_dkv_d256=cfg.n_layers, decode_split_d256=0)
    out["loss"] = loss
    print(f"{label}: one LoRA step (r16 on wq/wv, 2 x 512) through the Trainer: loss {loss:.4f}, dQ and dK/dV "
          f"{cfg.n_layers} launches each (mma design at 256); launches on this path {out['launches']}", flush=True)
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_adapters_phase(card: str) -> dict:
    """Multi-tenant LoRA at llama2-7b's full width (ADAPTERS_LAYERS deep):
    the seed-0 base written as an HF directory by tools/ckpt_writer.py, four tenants
    as contract artifacts (two of rank 16 on every target, one of rank 8 on
    wq/wv, one from a train.main LoRA step), served by serve.main
    --adapters-dir at capacity 2 on the paged pool in bf16 (a) and on the
    dense cache with int4 weights (b); then (c), the kernels at head_dim
    256 on a served and trained path."""
    import os
    import tempfile

    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve.adapters import load_adapter_artifact, save_adapter_artifact
    from substratus_tpu_torch.tools.ckpt_writer import write_hf
    from substratus_tpu_torch.train import main as train_main

    label = "serve-adapters"
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_adapters_"))
    try:
        cfg = llama.CONFIGS["llama2-7b"].replace(n_layers=ADAPTERS_LAYERS)
        source = llama.init_params(cfg, seed=0, device="cuda")
        disk_room(tmp, 2 * 13_500_000_000 * ADAPTERS_LAYERS // 32, label)
        t0 = time.perf_counter()
        written = write_hf(str(tmp / "llama2-7b"), source)
        print(f"{label}: llama2-7b (seed 0, bf16) written as {len(written['files'])} safetensors shards in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del source
        gc.collect()
        torch.cuda.empty_cache()
        adapters_dir = tmp / "adapters"
        for i, (aid, rank, alpha, targets) in enumerate(ADAPTER_SPECS):
            save_adapter_artifact(str(adapters_dir / aid), random_lora(cfg, 50 + i, rank, alpha, targets), alpha, rank)
        # The fourth tenant: one LoRA step of train.main on the HF directory
        # (rate 1e-3 from step 0, so B moves off zero); its adapter artifact
        # (the port's adapters.pt) is served as it is.
        _token_corpus(tmp / "data", cfg.vocab_size, 10_000)
        (tmp / "train.json").write_text(json.dumps(ADAPTER_TRAIN_PARAMS))
        res = train_main.run(["--model", str(tmp / "llama2-7b"), "--data", str(tmp / "data"), "--out",
                              str(tmp / "train"), "--params", str(tmp / "train.json")])
        losses = res["losses"]
        del res
        gc.collect()
        torch.cuda.empty_cache()
        shutil.move(str(tmp / "train" / "adapter"), str(adapters_dir / "trained"))
        shutil.rmtree(tmp / "train")
        arts = {aid: load_adapter_artifact(str(adapters_dir / aid)) for aid in ADAPTER_IDS}
        if not (all(x == x for x in losses) and any(ab["b"].any() for ab in arts["trained"][0].values())):
            fail(f"{label}: the train.main adapter: losses {losses}, its B all zero")
        sizes = {aid: sum(f.stat().st_size for f in (adapters_dir / aid).iterdir()) for aid in ADAPTER_IDS}
        print(f"{label}: four tenants in {adapters_dir}: {[(aid, arts[aid][2]['lora']) for aid in ADAPTER_IDS]}, "
              f"bytes {sizes}; the train.main step's loss {losses}", flush=True)

        def trees_of(engine):
            return {aid: plain_lora(layers, scale, engine.device, engine.cfg.dtype)
                    for aid, (layers, scale, _) in arts.items()}

        leg_a = adapters_leg(f"{label} (a)", ADAPTER_PARAMS, ADAPTER_PROMPTS, tmp / "llama2-7b", adapters_dir,
                             trees_of, card, merged_tenant="lora-a")
        engine = leg_a.pop("engine")
        # Load seconds a tenant: the artifact read, the host install (the
        # scale folded into b), the in-place copy to the card, synchronized.
        from substratus_tpu_torch.serve.adapters import AdapterStore

        store = AdapterStore(engine.cfg, capacity=4, rank=16, targets=ADAPTER_TARGETS, device="cuda")
        loads = {}
        for aid in ADAPTER_IDS:
            t0 = time.perf_counter()
            store.load(aid, str(adapters_dir / aid))
            store.sync()
            torch.cuda.synchronize()
            loads[aid] = time.perf_counter() - t0
        dev_bytes = sum(t.numel() * t.element_size() for t in (*store._dev_a.values(), *store._dev_b.values()))
        print(f"{label} [{card}]: load seconds a tenant (read, install, copy to the card): "
              + ", ".join(f"{aid} {s:.3f}" for aid, s in loads.items())
              + f"; the store's device tensors {dev_bytes} bytes at capacity 4", flush=True)
        del engine, store
        gc.collect()
        torch.cuda.empty_cache()
        prompts_b = ADAPTER_PROMPTS + [ADAPTER_LONG]
        leg_b = adapters_leg(f"{label} (b)", ADAPTER_INT4_PARAMS, prompts_b, tmp / "llama2-7b", adapters_dir,
                             trees_of, card)
        del leg_b["engine"]
        gc.collect()
        torch.cuda.empty_cache()
        leg_c = gemma_heads_leg(card)
        print(f"{label}: {time.perf_counter() - t_phase:.1f} s", flush=True)
        return {"a": leg_a, "b": leg_b, "c": leg_c, "loads_s": loads, "artifact_bytes": sizes,
                "train_losses": losses, "launches": leg_c["launches"], "launches_b": leg_b["launches"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- serve-moe: mixtral-8x7b, served and finetuned ----------------------------

# (a) and (b)'s depth: mixtral-8x7b's width at 4 of its 32 layers, cut once
# serve-gang's llama2-70b leg joined the default run (8) and again once its
# legs (f)-(i) did (every check as at full depth).
MOE_LAYERS = 4
MIXTRAL = (f"mixtral-8x7b at {MOE_LAYERS} layers", (4096, MOE_LAYERS, 32, 8, 32000))
MIXTRAL_2L = ("mixtral-8x7b's width at 2 layers", (4096, 2, 32, 8, 32000))
# (a) int4 weights drawn and quantized layer by layer on the card, the
# default engine: the paged pool, overlapped, the step a CUDA graph.
MOE_INT4_PARAMS = {"config": f"mixtral-8x7b@{MOE_LAYERS}", "quantize": "int4", "max_batch": 8, "max_seq_len": 2048,
                   "max_prefill_len": 512}
MOE_INT4_PROMPTS = [(f"[{i}] " + _long_text(n - 5, 70 + i), 32, 0.0, i == 1)
                    for i, n in enumerate((20, 48, 80, 130, 190, 250, 320, 400))]
# (b) int8 weights on the dense cache: the flash forward, the cached flash
# (a ~1500-token prompt in 3 chunks) and the decode kernel at GQA 4.
MOE_INT8_PARAMS = {"config": f"mixtral-8x7b@{MOE_LAYERS}", "quantize": "int8", "kv_layout": "dense", "kv_cache_dtype": "model",
                   "max_batch": 6, "max_seq_len": 2048, "max_prefill_len": 512}
MOE_INT8_PROMPTS = ([(_long_text(1499, 80), 32, 0.0, True)]
                    + [(f"[{i}] " + _long_text(n - 5, 81 + i), 32, 0.0, False) for i, n in enumerate((16, 60, 100,
                                                                                                      200, 300))])
# (c) the loader: 2 layers at full width written as a Mixtral HF directory,
# served by serve.main --model with int4 quantized at load; (d) LoRA on it.
MOE_CKPT_PARAMS = {"quantize": "int4", "max_batch": 2, "max_seq_len": 1024, "max_prefill_len": 512}
MOE_CKPT_PROMPTS = [("The experts route this prompt " * 4, 32, 0.0, False), ("x" * 300, 32, 0.0, True)]
MOE_TRAIN_PARAMS = {"steps": 3, "batch_size": 2, "seq_len": 512, "lora_rank": 16, "lora_alpha": 16,
                    "lora_targets": ["wq", "wv", "w_gate", "w_up", "w_down"], "learning_rate": 2e-4,
                    "save_steps": 3, "remat": True, "seed": 0}


# A mixture of experts in bf16 breaks the reference rule's premise: two
# correct paths (the served chunks and decode steps against one single-shot
# forward) round differently, a router near-tie then picks another expert
# for a token in one layer, and that token's state moves by a whole expert's
# output, in every later layer and, through its K and V, at every later
# position. Dense bf16 and f32 MoE do not depart (the CPU: a dense model's
# served tokens within the rule, an f32 MoE's the single-shot argmax every
# one; bf16 MoE 10-16% of the logit scale off at a few positions). So the
# served path is held token for token against the eager synchronous step
# (eager_check) and, against the single-shot forward, as a share: at least
# MOE_AGREE of the served greedy tokens within 5% of the logit scale of the
# best logit. A wrong kernel, weight or cache gives a share near 0.
MOE_AGREE = 0.75


def moe_reference_check(engine, requests, label: str) -> dict:
    """The served greedy tokens against one teacher-forced single-shot
    forward each (long_reference_check's reference): the share within 5%
    of the logit scale, at least MOE_AGREE; every logit finite."""
    import torch

    out, within, total = [], 0, 0
    for req in requests:
        prompt, toks = engine.clipped_prompt(req.prompt_tokens), req.out.tokens
        with torch.inference_mode():
            logits, _ = engine.model.forward(engine.params, torch.tensor([prompt + toks[:-1]], device=engine.device),
                                             engine.cfg)
        logits = logits[0, len(prompt) - 1:]
        if not toks or not torch.isfinite(logits).all():
            fail(f"{label}: no tokens or non-finite logits in the reference of a {len(prompt)}-token prompt")
        scale = logits.abs().max().item()
        gaps = (logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]) / scale
        ok = int((gaps <= 0.05).sum())
        first = next((i for i, g in enumerate(gaps.tolist()) if g > 0.05), None)
        out.append({"prompt_tokens": len(prompt), "tokens": len(toks), "within": ok,
                    "argmax_agree": sum(int(logits[i].argmax()) == t for i, t in enumerate(toks)),
                    "first_departure": first, "worst_gap_share": gaps.max().item()})
        within, total = within + ok, total + len(toks)
    share = within / total
    print(f"{label} reference: {within}/{total} served greedy tokens ({share:.3f}) within 5% of the logit scale of a "
          f"single-shot forward's best logit (at least {MOE_AGREE}); per request (prompt tokens: within/tokens, first "
          f"departure): " + ", ".join(f"{r['prompt_tokens']}: {r['within']}/{r['tokens']} {r['first_departure']}"
                                        for r in out), flush=True)
    if share < MOE_AGREE:
        fail(f"{label}: {share:.3f} of the served tokens within the single-shot reference's 5%, below {MOE_AGREE}")
    return {"share": share, "requests": out}


def _moe_bytes(engine, peak: int) -> dict:
    """Bytes on the card: the weights, the KV store, all allocated, and
    the peak while the model was drawn (or loaded) and quantized."""
    import torch

    cache = engine.cache.values() if isinstance(engine.cache, dict) else ()
    return {"weights": sum(t.numel() * t.element_size() for t in engine.params.state_dict().values()
                           if torch.is_tensor(t)),
            "kv": sum(t.numel() * t.element_size() for t in cache), "allocated": torch.cuda.memory_allocated(),
            "peak_while_building": peak}


def _free_card() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def moe_int4_leg(card: str, profile_steps: bool) -> dict:
    """(a) int4 mixtral-8x7b through serve.main on the default engine."""
    import torch

    from substratus_tpu_torch.ops.quant4 import Q4Tensor

    label = "serve-moe (a) int4"
    _free_card()
    t0 = time.perf_counter()
    server, engine, base = start_server("serve-moe-int4", MOE_INT4_PARAMS, model=MIXTRAL)
    nbytes = _moe_bytes(engine, torch.cuda.max_memory_allocated())
    lp = engine.params.layers[0]
    if not engine.paged or not isinstance(lp.w_gate, Q4Tensor) or lp.w_gate.packed.shape != (8, 2048, 14336):
        fail(f"{label}: not int4 experts on the paged pool: paged={engine.paged}, {type(lp.w_gate).__name__}")
    print(f"{label}: drawn and quantized layer by layer and served in {time.perf_counter() - t0:.1f} s; bytes "
          f"{nbytes}: the peak while building is the int4 model plus "
          f"{(nbytes['peak_while_building'] - nbytes['weights']) / 2**30:.2f} GiB (one bf16 layer is 2.72 GiB)",
          flush=True)
    counters = int4_counters()
    requests = tee_requests(engine)
    try:
        zero_counts(engine, counters.values())
        results, wall = run_concurrent(base, MOE_INT4_PROMPTS)
        wait_idle(engine)
        launches = int4_launches(engine, counters)
        stats = dict(engine.stats)
    finally:
        server.stop()
    generated = check_usage(MOE_INT4_PROMPTS, results)
    del engine.submit
    check_graph_run(engine, stats, label)
    E = engine.cfg.n_experts
    check_int4_launches(engine, stats, launches, [len(text.encode()) + 1 for text, *_ in MOE_INT4_PROMPTS], label,
                        per_layer=4 + 3 * E)
    reference = moe_reference_check(engine, requests, label)
    eager = eager_check(engine, requests, label)
    profiled = profile_engine(engine, f"{label} profile", (16, 400)) if profile_steps else None
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    prefill_ms = 1e3 * stats["prefill_seconds"] / len(MOE_INT4_PROMPTS)
    decode_tps = (generated - len(MOE_INT4_PROMPTS)) / stats["decode_seconds"]
    print(f"{label} [{card}]: {len(MOE_INT4_PROMPTS)} concurrent requests, {generated} tokens in {wall:.2f} s; "
          f"{stats['prefill_chunks']} prefill chunks, {stats['decode_steps']} decode steps; mean step {step_ms:.2f} ms "
          f"(overlapped, the step one CUDA graph; {(4 + 3 * E) * MOE_LAYERS + 1} int4 launches a forward), mean prefill "
          f"{prefill_ms:.1f} ms a request, decode {decode_tps:.1f} tokens/s; launches {launches}", flush=True)
    del engine, server
    _free_card()
    return {"launches": launches, "stats": stats, "bytes": nbytes, "wall_s": wall, "generated": generated,
            "step_ms": step_ms, "prefill_ms": prefill_ms, "decode_tokens_per_s": decode_tps, "reference": reference,
            "eager_sync": eager, "profile": profiled}


def moe_int8_leg(card: str, profile_steps: bool) -> dict:
    """(b) int8 mixtral-8x7b on the dense cache: the attention kernels."""
    import torch

    from substratus_tpu_torch.ops.quant import QTensor

    label = "serve-moe (b) int8 dense"
    _free_card()
    t0 = time.perf_counter()
    server, engine, base = start_server("serve-moe-int8", MOE_INT8_PARAMS, model=MIXTRAL)
    nbytes = _moe_bytes(engine, torch.cuda.max_memory_allocated())
    if engine.paged or not isinstance(engine.params.layers[-1].w_down, QTensor):
        fail(f"{label}: not int8 experts on the dense cache")
    print(f"{label}: built in {time.perf_counter() - t0:.1f} s; bytes {nbytes}", flush=True)
    requests = tee_requests(engine)
    try:
        zero_counts(engine, _serving_counters())
        torch.cuda.reset_peak_memory_stats()
        results, wall = run_concurrent(base, MOE_INT8_PROMPTS)
        wait_idle(engine)
        serving_peak = torch.cuda.max_memory_allocated()
        launches = _serving_launches(engine)
        stats = dict(engine.stats)
    finally:
        server.stop()
    generated = check_usage(MOE_INT8_PROMPTS, results)
    del engine.submit
    check_graph_run(engine, stats, label)
    _check_serving_launches(launches, stats, engine.cfg.n_layers, label)
    if (stats["prefill_chunks"], stats["prefills"]) != (3, 5):
        fail(f"{label}: {stats['prefill_chunks']} chunks and {stats['prefills']} prefills, want 3 and 5")
    reference = moe_reference_check(engine, requests, label)
    eager = eager_check(engine, requests, label)
    profiled = profile_engine(engine, f"{label} profile", (16, 512)) if profile_steps else None
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    prefill_ms = 1e3 * stats["prefill_seconds"] / len(MOE_INT8_PROMPTS)
    decode_tps = (generated - len(MOE_INT8_PROMPTS)) / stats["decode_seconds"]
    print(f"{label} [{card}]: {len(MOE_INT8_PROMPTS)} concurrent requests, {generated} tokens in {wall:.2f} s; "
          f"{stats['prefills']} prefills, {stats['prefill_chunks']} chunks, {stats['decode_steps']} decode steps; "
          f"mean step {step_ms:.2f} ms, mean prefill {prefill_ms:.1f} ms a request, decode {decode_tps:.1f} tokens/s; "
          f"the peak while serving {serving_peak} bytes (the weights {nbytes['weights']}: the int8 experts' bf16 "
          f"copies and the dropless intermediates above them); launches {launches}: the decode kernel at G = 4 "
          f"(the split design) {launches['decode_attn_split']} times", flush=True)
    del engine, server
    _free_card()
    return {"launches": launches, "stats": stats, "bytes": nbytes, "serving_peak": serving_peak, "wall_s": wall,
            "generated": generated, "step_ms": step_ms, "prefill_ms": prefill_ms,
            "decode_tokens_per_s": decode_tps, "reference": reference, "eager_sync": eager, "profile": profiled}


def moe_ckpt_leg(card: str, tmp: Path) -> dict:
    """(c) a Mixtral HF directory (2 layers at full width, seed 0, bf16)
    written by tools/ckpt_writer.py and served by serve.main --model with
    int4 quantized at load, layer by layer."""
    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve import main as serve_main
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    label = "serve-moe (c) loader"
    cfg = llama.CONFIGS["mixtral-8x7b"].replace(n_layers=2)
    _free_card()
    source = llama.init_params(cfg, seed=0, device="cuda")
    nbytes = sum(t.numel() * t.element_size() for t in source.state_dict().values())
    disk_room(tmp, nbytes, label)
    t0 = time.perf_counter()
    written = write_hf(str(tmp / "mixtral"), source)
    write_s = time.perf_counter() - t0
    config = json.loads((tmp / "mixtral" / "config.json").read_text())
    del source
    _free_card()
    print(f"{label}: written as {len(written['files'])} safetensors shards, {written['bytes']} bytes in "
          f"{write_s:.1f} s; config.json model_type {config['model_type']}, {config['num_local_experts']} experts",
          flush=True)
    load, loads = serve_main.load_checkpoint, []

    def timed(*args, **kw):  # the load's seconds and the card's peak during it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = load(*args, **kw)
        torch.cuda.synchronize()
        loads.append((time.perf_counter() - t, torch.cuda.max_memory_allocated() - base_bytes))
        return out

    serve_main.load_checkpoint = timed
    try:
        server, engine, base = start_server("serve-moe-ckpt", MOE_CKPT_PARAMS, ["--model", str(tmp / "mixtral")],
                                            model=MIXTRAL_2L)
    finally:
        serve_main.load_checkpoint = load
    requests = tee_requests(engine)
    try:
        want = llama.init_params(cfg, seed=0, device="cuda", quantize="int4")  # = quantize(the written bf16)
        compared = same_state(engine.params, want, label)
        qbytes = sum(t.numel() * t.element_size() for t in want.state_dict().values() if torch.is_tensor(t))
        del want
        counters = int4_counters()
        zero_counts(engine, counters.values())
        results, wall = run_concurrent(base, MOE_CKPT_PROMPTS)
        wait_idle(engine)
        launches = int4_launches(engine, counters)
        stats = dict(engine.stats)
        del engine.submit
    finally:
        server.stop()
    check_usage(MOE_CKPT_PROMPTS, results)
    check_int4_launches(engine, stats, launches, [len(text.encode()) + 1 for text, *_ in MOE_CKPT_PROMPTS], label,
                        per_layer=4 + 3 * cfg.n_experts)
    reference = moe_reference_check(engine, requests, label)
    load_s, load_peak = loads[0]
    over = load_peak - qbytes
    print(f"{label} [{card}]: loaded {written['bytes']} bytes of bf16 in {load_s:.2f} s "
          f"({written['bytes'] / load_s / 1e9:.2f} GB/s) and quantized to int4 at load, {compared} bytes bit for "
          f"bit quantize(the source); the load's peak {load_peak} bytes, {over} above the {qbytes} quantized "
          f"({over / 2**30:.2f} GiB; one bf16 layer is {cfg.n_experts * 3 * cfg.dim * cfg.hidden_dim * 2 / 2**30:.2f} "
          f"GiB of experts)", flush=True)
    if over > 2 * 2**30 + cfg.n_experts * 3 * cfg.dim * cfg.hidden_dim * 2:
        fail(f"{label}: the load's peak is {over} bytes above the quantized model, more than a dense layer + 2 GiB")
    del engine, server
    _free_card()
    return {"bytes": written["bytes"], "write_s": write_s, "load_s": load_s, "load_peak_over_quantized": over,
            "launches": launches, "stats": stats, "reference": reference, "wall_s": wall}


def moe_train_leg(card: str, tmp: Path) -> dict:
    """(d) LoRA r16 on wq, wv and the expert-routed w_gate/w_up/w_down
    through train.main on (c)'s directory: capacity dispatch in every
    forward, the router's aux in the loss, the gradients through the
    kernels against the plain attention."""
    import numpy as np
    import torch

    from substratus_tpu_torch.load.hf import load_pretrained
    from substratus_tpu_torch.train.trainer import TrainConfig, Trainer
    from substratus_tpu_torch.train import main as train_main

    label = "serve-moe (d) LoRA"
    _free_card()
    _token_corpus(tmp / "moe-data", 32000, 100_000)
    params_path = tmp / "moe-train.json"
    params_path.write_text(json.dumps(MOE_TRAIN_PARAMS))
    # One step's gradients through the kernels against the plain attention,
    # on the checkpoint's weights, before the run.
    cfg, params = load_pretrained(str(tmp / "mixtral"))
    p = MOE_TRAIN_PARAMS
    trainer = Trainer(cfg, TrainConfig(lora_rank=p["lora_rank"], lora_alpha=p["lora_alpha"],
                                       lora_targets=tuple(p["lora_targets"]), remat=True), params=params)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 512)).astype(np.int64),
             "weights": np.ones((2, 512), np.float32)}
    for layer in trainer.lora.layers:  # B away from zero, so that A has a gradient too
        for ab in layer.values():
            torch.nn.init.normal_(ab["b"], std=0.01)
    grads = grad_check(trainer, batch, label)
    with torch.no_grad():
        _, kv = trainer.model.forward(trainer.params, torch.from_numpy(batch["tokens"]).cuda(), cfg, train=True)
    aux = kv["moe_aux"].tolist()
    capacity = max(1, int(cfg.capacity_factor * 512 * cfg.n_experts_per_token / cfg.n_experts))
    del trainer, params, kv
    _free_card()
    _zero_train_counts()
    t0 = time.perf_counter()
    res = train_main.run(["--model", str(tmp / "mixtral"), "--data", str(tmp / "moe-data"), "--out",
                          str(tmp / "moe-out"), "--params", str(params_path)])
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    train_launches = _train_launches()
    n, L = len(res["losses"]), cfg.n_layers
    want = {"flash_fwd": 2 * L * n, "flash_fwd_all": 2 * L * n, "flash_bwd_dq": L * n, "flash_bwd_dq_all": L * n,
            "flash_bwd_dkv": L * n, "flash_bwd_dkv_all": L * n}
    experts = res["trainer"].lora.layers[0]["w_gate"]["a"].shape
    if n != p["steps"] or train_launches != want or not all(map(math.isfinite, res["losses"])) \
            or tuple(experts) != (cfg.n_experts, cfg.dim, p["lora_rank"]):
        fail(f"{label}: {n} steps, losses {res['losses']}, launches {train_launches} (want {want}), expert "
             f"adapters {tuple(experts)}")
    print(f"{label} [{card}]: train.main {n} steps of batch 2 x 512 (LoRA r16 on {','.join(p['lora_targets'])}, "
          f"expert-routed pairs {tuple(experts)}, capacity {capacity} a expert) in {train_s:.1f} s: losses "
          f"{[round(x, 4) for x in res['losses']]}, step {[round(x, 3) for x in res['step_seconds']]} s, peak "
          f"{peak / 2**30:.1f} GiB, launches {train_launches}; moe_aux per layer {[round(a, 4) for a in aux]} "
          f"(1.0 is balanced)", flush=True)
    del res
    _free_card()
    return {"train_launches": train_launches, "grads": grads, "moe_aux": aux, "capacity": capacity,
            "train_s": train_s, "peak_bytes": peak}


def serve_moe_phase(card: str, profile_steps: bool = False) -> dict:
    """mixtral-8x7b at full width: (a) int4 at MOE_LAYERS layers through
    serve.main on the default engine, (b) int8 at MOE_LAYERS on the dense
    cache, (c) a 2-layer Mixtral HF directory quantized at load, (d) LoRA on
    it through train.main (module docstring). Files live in a temporary
    directory removed at the end."""
    import tempfile

    at_depth("mixtral-8x7b", MOE_LAYERS)
    a = moe_int4_leg(card, profile_steps)
    b = moe_int8_leg(card, profile_steps)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_"))
    try:
        c = moe_ckpt_leg(card, tmp)
        d = moe_train_leg(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    la, lb, lc, ld = a["launches"], b["launches"], c["launches"], d["train_launches"]
    launches = {"q4_matmul_decode": la["q4_matmul_decode"] + lc["q4_matmul_decode"],
                "q4_matmul_wgmma": la["q4_matmul_wgmma"] + lc["q4_matmul_wgmma"],
                "q4_matmul": la["q4_matmul"] + lc["q4_matmul"],
                "flash_fwd_wgmma": lb["flash_fwd_wgmma"] + ld["flash_fwd"],
                "flash_cached_wgmma": lb["flash_cached_wgmma"], "decode_attn_split": lb["decode_attn_split"],
                "flash_bwd_dq": ld["flash_bwd_dq"], "flash_bwd_dkv": ld["flash_bwd_dkv"]}
    print(f"serve-moe: launches over its legs {launches}", flush=True)
    return {"int4": a, "int8": b, "ckpt": c, "train": d, "launches": launches}


# --- disaggregated prefill/decode: serve.main tiers on one card ---------------

# The JAX package's int4 serving stack on the paged pool (int8 pages) at
# llama2-7b's full width and DISAGG_LAYERS of its layers, every tier loading
# the same seed-0 weights from one HF directory (quantized at load): a
# monolith, a prefill tier on an int8 pool, one on a bf16 pool, and two
# decode tiers on int8 pools, each serve.main in a child process. The depth
# was cut from 32 once serve-gang's llama2-70b leg joined the default run
# (every check as at full depth; at 4 layers (c)'s survivor parted from the
# monolith's tokens, so 8 stays).
DISAGG_LAYERS = 8
DISAGG_PARAMS = {"quantize": "int4", "kv_cache_dtype": "int8", "max_batch": 8, "max_seq_len": 2048,
                 "max_prefill_len": 512}
# Leg (a): 8 greedy requests of 20-1500 tokens, 64 new tokens each; the
# 1500-token prompt runs as 3 chunks, the 520-token one as 512 + an 8-token
# chunk (the int4 decode design on the prefill tier).
DISAGG_LENS = (20, 60, 150, 300, 520, 800, 1100, 1500)
DISAGG_NEW = 64
DISAGG_B_LENS = (20, 300, 520, 1500)  # leg (b): a bf16 pool's pages into an int8 pool
DISAGG_TTFT_LENS = (20, 520, 1500)
DISAGG_SHIP_TIMEOUT_S = 30.0  # HandoffManager's default, which serve.main keeps


def page_token_bytes(cfg, int8: bool) -> int:
    """The bytes a token's pages ship: k and v over every layer and kv head
    (llama2-7b: 524,288 in bf16; 270,336 in int8 with f32 scales)."""
    import torch

    vectors = 2 * cfg.n_layers * cfg.n_kv_heads
    return vectors * (cfg.head_size + 4) if int8 else vectors * cfg.head_size * torch.empty(
        0, dtype=cfg.dtype).element_size()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class DisaggChild:
    """serve.main as one tier in a child process, its output in
    OUT_DIR/serve_disagg_{name}.log."""

    def __init__(self, name: str, params: dict, args, env: dict):
        OUT_DIR.mkdir(exist_ok=True)
        self.name = name
        path = OUT_DIR / f"chip_smoke_params_serve-disagg-{name}.json"
        path.write_text(json.dumps(params))
        self.log = (OUT_DIR / f"serve_disagg_{name}.log").open("w")
        self.lines = []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", "substratus_tpu_torch.serve.main", "--params", str(path),
                                      "--host", "127.0.0.1", "--port", "0", *args],
                                     cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.log.write(line)
            self.log.flush()
            self.lines.append(line)

    def wait_ready(self, timeout: float = 300) -> str:
        """The child's base URL once GET / answers 200 (the model drawn and
        quantized, the engine started)."""
        while not any(ln.startswith("serving ") for ln in self.lines):
            if self.proc.poll() is not None or time.perf_counter() - self.t0 > timeout:
                fail(f"serve-disagg: the {self.name} tier did not start: {''.join(self.lines[-20:])}")
            time.sleep(0.1)
        self.serving = next(ln for ln in self.lines if ln.startswith("serving "))
        self.base = f"http://127.0.0.1:{int(self.serving.split('127.0.0.1:')[1].split()[0])}"
        wait_ok(self.base, f"serve-disagg: the {self.name} tier", deadline_s=timeout)
        self.ready_s = time.perf_counter() - self.t0
        return self.base

    @property
    def digest(self) -> str:
        return self.serving.split("weights digest ")[1].split(";")[0]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.reader.join(timeout=10)
        self.log.close()


def stream_times(base: str, body: dict, headers=None, on_chunk=None) -> dict:
    """One streamed completion: the host clock of each token's chunk, its
    pieces, the finish reason and usage; `on_chunk(n)` runs after the n-th
    token's chunk."""
    body = {**body, "stream": True, "stream_options": {"include_usage": True}}
    req = urllib.request.Request(f"{base}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    t0, times, pieces, finish, usage = time.perf_counter(), [], [], None, None
    with LOCAL.open(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: {"):
                continue
            obj = json.loads(line[6:])
            usage = obj.get("usage") or usage
            for ch in obj["choices"]:
                if ch["finish_reason"] is not None:
                    finish = ch["finish_reason"]
                    continue
                times.append(time.perf_counter())
                pieces.append(ch["text"])
                if on_chunk is not None:
                    on_chunk(len(times))
    return {"t0": t0, "times": times, "pieces": pieces, "finish": finish, "usage": usage, "end": time.perf_counter()}


def disagg_trace(tag: int, i: int) -> str:
    return f"{tag:08x}" + f"{i:024x}"


def journey_of(base: str, trace: str, label: str) -> dict:
    status, _, text = http(base, f"/debug/requestz?id={trace}", timeout=60)
    if status != 200:
        fail(f"{label}: /debug/requestz?id={trace} -> {status} {text[:200]}")
    return json.loads(text)["journey"]


def emitted(events) -> list:
    return [e[2]["t"] for e in events if e[1] == "emit"]


def post_traced(base: str, items, tag: int, label: str) -> tuple:
    """Every item (a completion's body, and `after`: an item's index) at
    once, each under its own trace id; an item with `after` once that
    item's request has ended (a tenant hot-loaded mid-run). (Each
    request's journey from `base` afterwards, the responses, the wall
    seconds.)"""
    ended = [threading.Event() for _ in items]
    results = [None] * len(items)

    def one(i, item):
        try:
            if "after" in item:
                ended[item["after"]].wait(timeout=600)
            body = {k: v for k, v in item.items() if k != "after"}
            results[i] = http(base, "/v1/completions", body, timeout=300, headers={
                "traceparent": f"00-{disagg_trace(tag, i)}-{'ab' * 8}-01"})
        except Exception as e:  # reported below as a failed request
            results[i] = (None, {}, repr(e))
        finally:
            ended[i].set()

    threads = [threading.Thread(target=one, args=(i, item)) for i, item in enumerate(items)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for i, res in enumerate(results):
        if res is None or res[0] != 200 or not json.loads(res[2])["usage"]["completion_tokens"]:
            fail(f"{label}: request {i} -> {res and res[0]} {res and res[2][:200]}")
    return ([journey_of(base, disagg_trace(tag, i), label) for i in range(len(items))],
            [json.loads(res[2]) for res in results], wall)


def run_traced(base: str, prompts, tag: int, new_tokens: int, label: str) -> list:
    """Every (text) at once, greedy, each under its own trace id; each
    request's journey from `base` afterwards."""
    journeys, _, wall = post_traced(base, [{"prompt": text, "max_tokens": new_tokens, "temperature": 0}
                                           for text in prompts], tag, label)
    return journeys, wall


def handoff_rows(journeys) -> list:
    """Per handoff: its ship (prefill tier) and kv_recv (decode tier) data."""
    rows = []
    for j in journeys:
        ship = next(e[2] for e in j["events"] if e[1] == "ship")
        recv = next(e[2] for e in j["segments"][-1]["events"] if e[1] == "kv_recv")
        rows.append({"tokens": ship["tokens"], "pages": ship["pages"], "bytes": ship["bytes"],
                     "export_ms": ship["export_us"] / 1e3, "recv_bytes": recv["bytes"],
                     "stage_ms": recv["stage_us"] / 1e3, "stage_gb_s": recv["bytes"] / max(recv["stage_us"], 1) / 1e3})
    return rows


def transfer_seconds(base: str) -> tuple:
    s = scrape(base)["samples"]
    return (s.get("substratus_serve_kv_transfer_seconds_sum", 0.0),
            s.get("substratus_serve_kv_transfer_seconds_count", 0.0))


def tier_launches(base: str) -> dict:
    """A tier's int4 matmul launches by design (wrapper counts plus graph
    replays, from its /metrics)."""
    c = surface_launches(scrape(base))
    return {"q4_matmul_decode": c.get("q4_matmul.launches_decode", 0),
            "q4_matmul_wgmma": c.get("q4_matmul.launches_wgmma", 0),
            "q4_matmul": c.get("q4_matmul.launches_mma", 0), "all": c.get("q4_matmul.launches", 0)}


def itl_run(base: str, label: str, seed: int) -> dict:
    """6 short greedy streams; once each has its first token, two
    1500-token prompts arrive. The streams' inter-token gaps inside the
    burst's window (its send to both answers) and outside it."""
    shorts = [_long_text(31, seed * 100 + i) for i in range(6)]
    longs = [_long_text(1499, seed * 100 + 50 + i) for i in range(2)]
    firsts = threading.Semaphore(0)
    out = [None] * 6

    def short(i):
        out[i] = stream_times(base, {"prompt": shorts[i], "max_tokens": 40, "temperature": 0},
                              on_chunk=lambda n: n == 1 and firsts.release())

    threads = [threading.Thread(target=short, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for _ in threads:
        if not firsts.acquire(timeout=120):
            fail(f"{label}: a short stream never started")
    t_burst = time.perf_counter()
    burst = [threading.Thread(target=http, args=(base, "/v1/completions",
                                                 {"prompt": text, "max_tokens": 4, "temperature": 0}))
             for text in longs]
    for t in burst:
        t.start()
    for t in burst:
        t.join()
    t_done = time.perf_counter()
    for t in threads:
        t.join()
    inside, outside = [], []
    for r in out:
        if r["usage"] is None:
            fail(f"{label}: a short stream ended {r['finish']} with no usage")
        for a, b in zip(r["times"], r["times"][1:]):
            (inside if t_burst <= b and a <= t_done else outside).append(b - a)
    if not inside:
        fail(f"{label}: no stream decoded while the burst arrived")
    return {"burst_s": t_done - t_burst, "max_gap_ms": 1e3 * max(inside), "mean_gap_in_ms": 1e3 * statistics.mean(inside),
            "mean_gap_out_ms": 1e3 * statistics.mean(outside) if outside else None, "gaps_in": len(inside)}


def disagg_reference(tiers_model, journeys, prompts, label: str) -> dict:
    """The 5% near-tie rule of long_reference_check on each request's
    served tokens (from its journey) against a single-shot forward on the
    in-process copy of the tiers' weights."""
    from types import SimpleNamespace

    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    cfg, params, family = tiers_model
    tok = ByteTokenizer()
    engine = SimpleNamespace(clipped_prompt=lambda p: p[-(DISAGG_PARAMS["max_seq_len"] - 1):], device=params.device,
                             model=family, params=params, cfg=cfg)
    requests = [SimpleNamespace(prompt_tokens=tok.encode(text), out=SimpleNamespace(tokens=emitted(
        j["segments"][-1]["events"]))) for j, text in zip(journeys, prompts)]
    return long_reference_check(engine, requests, label, quiet=True)


def send_probe(nbytes: int) -> dict:
    """The handoff send's two parts outside a tier, in this process:
    encode_pages (the payload's one copy of pinned pages) and one frame of
    it through send_frame -> recv_frame over loopback TCP."""
    import socket

    import torch

    from substratus_tpu_torch.serve import disagg

    pages = {n: torch.zeros(nbytes // 2, dtype=torch.int8, pin_memory=True) for n in ("k", "v")}
    t0 = time.perf_counter()
    manifest, payload = disagg.encode_pages(pages)
    encode_s = time.perf_counter() - t0
    done = {}
    with socket.create_server(("127.0.0.1", 0)) as srv:
        def read():
            conn, _ = srv.accept()
            with conn:
                done["bytes"] = len(disagg.recv_frame(conn)[1])

        reader = threading.Thread(target=read)
        reader.start()
        with socket.create_connection(srv.getsockname(), timeout=60) as sock:
            t0 = time.perf_counter()
            disagg.send_frame(sock, {"t": "kv", "arrays": manifest}, payload)
            reader.join(timeout=60)
            socket_s = time.perf_counter() - t0
    if done.get("bytes") != nbytes:
        fail(f"serve-disagg: the send probe moved {done.get('bytes')} of {nbytes} bytes")
    return {"bytes": nbytes, "encode_ms": 1e3 * encode_s, "socket_ms": 1e3 * socket_s,
            "socket_gb_s": nbytes / socket_s / 1e9}


def serve_disagg_phase(card: str) -> dict:
    """Disaggregated prefill/decode through serve.main at llama2-7b's full
    width, DISAGG_LAYERS deep, on one card (module docstring): a monolith, two prefill
    tiers and two decode tiers as child processes; legs (a) same-dtype pair
    against the monolith, token for token, (b) a bf16 pool's pages
    quantized into an int8 pool, held by the 5% rule, TTFT, (c) failover,
    the inter-token gaps in turns (the pair down to one decode tier, as the
    monolith is one engine), then the last worker's loss."""
    import os
    import tempfile

    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve import main as serve_main
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    label = "serve-disagg"
    _free_card()
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_disagg_"))
    disk_room(tmp, 13_500_000_000 * DISAGG_LAYERS // 32, label)
    model = llama.init_params(llama.CONFIGS["llama2-7b"].replace(n_layers=DISAGG_LAYERS), seed=0, device="cuda")
    write_hf(str(tmp / "llama2-7b"), model)
    del model
    _free_card()
    tier_params = {**DISAGG_PARAMS, "model": str(tmp / "llama2-7b")}
    print(f"{label}: llama2-7b at {DISAGG_LAYERS} of its 32 layers (seed 0) written as an HF directory in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(Path(__file__).resolve().parent) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("SUBSTRATUS_SERVE_ROLE", None)
    ports = [free_port(), free_port()]
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    bf16_pool = {**tier_params, "kv_cache_dtype": "model"}
    specs = {"mono": (tier_params, []),
             "decode1": (tier_params, ["--role", "decode", "--transfer-port", str(ports[0])]),
             "decode2": (tier_params, ["--role", "decode", "--transfer-port", str(ports[1])]),
             "prefill": (tier_params, ["--role", "prefill", "--decode-peers", peers]),
             "prefill_bf16": (bf16_pool, ["--role", "prefill", "--decode-peers", peers])}
    children = {}
    try:
        for name, (params, args) in specs.items():
            children[name] = DisaggChild(name, params, args, env)
        # The same weights in this process, drawn as every tier draws them:
        # the digests must agree, and leg (b)'s reference runs on them.
        cfg, params, _, _, family, _ = serve_main.load_model(None, None, tier_params, torch.device("cuda"), "int4")
        digest = serve_main.weights_digest(params)
        bases = {name: child.wait_ready() for name, child in children.items()}
        digests = {name: child.digest for name, child in children.items()}
        if set(digests.values()) != {digest}:
            fail(f"{label}: the tiers' weights differ: {digests}, this process's {digest}")
        print(f"{label}: 5 tiers ready in {max(c.ready_s for c in children.values()):.1f} s "
              f"({', '.join(f'{n} {c.ready_s:.1f}' for n, c in children.items())}); weights digest {digest} in "
              f"every tier and here; {torch.cuda.mem_get_info()[1] - torch.cuda.mem_get_info()[0]} bytes of the card "
              "in use", flush=True)
        # Warm-ups: cuBLAS handles, each decode tier's graph capture (the
        # prefill tiers hand off round-robin), the monolith's.
        for name in ("mono", "prefill", "prefill", "prefill_bf16", "prefill_bf16"):
            status = http(bases[name], "/v1/completions", {"prompt": "warm up", "max_tokens": 4, "temperature": 0})[0]
            if status != 200:
                fail(f"{label}: the warm-up through {name} -> {status}")
        start = {name: tier_launches(b) for name, b in bases.items()}

        # (a) the same-dtype pair against the monolith, token for token.
        prompts = [_long_text(n - 1, 40 + i) for i, n in enumerate(DISAGG_LENS)]
        mono_j, mono_wall = run_traced(bases["mono"], prompts, 0xa0, DISAGG_NEW, f"{label} (a)")
        t_sum0, t_count0 = transfer_seconds(bases["prefill"])
        pair_j, pair_wall = run_traced(bases["prefill"], prompts, 0xa0, DISAGG_NEW, f"{label} (a)")
        t_sum1, t_count1 = transfer_seconds(bases["prefill"])
        for i, (m, p) in enumerate(zip(mono_j, pair_j)):
            want, got = emitted(m["events"]), emitted(p["segments"][-1]["events"]) if p["segments"] else []
            if got != want or not got:
                first = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
                fail(f"{label} (a): the {DISAGG_LENS[i]}-token request's tokens through the pair differ from the "
                     f"monolith's at token {first}: {got[:8]}... against {want[:8]}...")
            if p["segments"][-1]["trace_id"] != p["trace_id"] or p["trace_id"] != disagg_trace(0xa0, i):
                fail(f"{label} (a): the decode segment's trace id {p['segments'][-1]['trace_id']} is not the request's")
        rows = handoff_rows(pair_j)
        for n, r in zip(DISAGG_LENS, rows):
            if r["pages"] != -(-(n + 1) // 16) or r["bytes"] != r["recv_bytes"] \
                    or r["bytes"] != r["pages"] * 16 * page_token_bytes(cfg, int8=True):
                fail(f"{label} (a): the {n}-token handoff's pages and bytes {r}")
        sends = int(t_count1 - t_count0)
        print(f"{label} (a) [{card}]: {len(prompts)} concurrent greedy requests of {min(DISAGG_LENS)}-"
              f"{max(DISAGG_LENS)} tokens, up to {DISAGG_NEW} new each, through the int8 pair: every token the "
              f"monolith's ({sum(len(emitted(m['events'])) for m in mono_j)}); wall {pair_wall:.2f} s (monolith {mono_wall:.2f} s); {sends} sends, "
              f"kv_transfer_seconds mean {(t_sum1 - t_sum0) / max(sends, 1) * 1e3:.1f} ms", flush=True)
        for n, r in zip(DISAGG_LENS, rows):
            print(f"{label} (a) handoff: {n} tokens, {r['pages']} pages, {r['bytes']} bytes, export (gather + read "
                  f"to pinned host memory) {r['export_ms']:.2f} ms, decode tier's staging (into pinned memory and "
                  f"onto the card) {r['stage_ms']:.2f} ms, {r['stage_gb_s']:.2f} GB/s", flush=True)

        # (b) a bf16 pool's pages into the int8 pools (quantized on import).
        b_prompts = [_long_text(n - 1, 60 + i) for i, n in enumerate(DISAGG_B_LENS)]
        b_j, b_wall = run_traced(bases["prefill_bf16"], b_prompts, 0xb0, 32, f"{label} (b)")
        b_rows = handoff_rows(b_j)
        for n, r in zip(DISAGG_B_LENS, b_rows):
            if r["bytes"] != r["pages"] * 16 * page_token_bytes(cfg, int8=False):
                fail(f"{label} (b): the {n}-token handoff shipped {r['bytes']} bytes, not bf16 pages")
        reference = disagg_reference((cfg, params, family), b_j, b_prompts, f"{label} (b)")
        print(f"{label} (b) [{card}]: {len(b_prompts)} requests of {DISAGG_B_LENS} tokens from the bf16 pool into "
              f"the int8 pools, 32 new each, in {b_wall:.2f} s; bf16 pages {[r['bytes'] for r in b_rows]} bytes, "
              f"staged at {[round(r['stage_gb_s'], 2) for r in b_rows]} GB/s", flush=True)

        # TTFT: one streamed request at a time through the monolith and the pair.
        ttft = []
        for i, n in enumerate(DISAGG_TTFT_LENS):
            text = _long_text(n - 1, 80 + i)
            trace = disagg_trace(0xc0, i)
            tp = {"traceparent": f"00-{trace}-{'ab' * 8}-01"}
            m = stream_times(bases["mono"], {"prompt": text, "max_tokens": 8, "temperature": 0}, tp)
            s0 = transfer_seconds(bases["prefill"])
            p = stream_times(bases["prefill"], {"prompt": text, "max_tokens": 8, "temperature": 0}, tp)
            s1 = transfer_seconds(bases["prefill"])
            (row,) = handoff_rows([journey_of(bases["prefill"], trace, f"{label} TTFT")])
            row.update(prompt=n, ttft_mono_ms=1e3 * (m["times"][0] - m["t0"]), ttft_pair_ms=1e3 * (p["times"][0] - p["t0"]),
                       send_ms=1e3 * (s1[0] - s0[0]), sends=int(s1[1] - s0[1]))
            ttft.append(row)
            print(f"{label} TTFT [{card}]: {n}-token prompt, monolith {row['ttft_mono_ms']:.1f} ms, pair "
                  f"{row['ttft_pair_ms']:.1f} ms (client, streamed); its handoff {row['pages']} pages, {row['bytes']} "
                  f"bytes, export {row['export_ms']:.2f} ms, send (kv_transfer_seconds) {row['send_ms']:.2f} ms, "
                  f"staging {row['stage_ms']:.2f} ms ({row['stage_gb_s']:.2f} GB/s)", flush=True)

        probe = send_probe(406_585_344)
        print(f"{label} send probe [{card}]: the 1500-token handoff's 406585344 bytes in this process: encode_pages "
              f"{probe['encode_ms']:.1f} ms, one frame over loopback TCP {probe['socket_ms']:.1f} ms "
              f"({probe['socket_gb_s']:.2f} GB/s)", flush=True)
        end = {name: tier_launches(b) for name, b in bases.items()}
        launches = {name: {k: end[name][k] - start[name][k] for k in end[name]} for name in end}
        for name, got in launches.items():
            decode_tier = name.startswith("decode")
            if got["q4_matmul"] or not got["q4_matmul_decode"] or bool(got["q4_matmul_wgmma"]) == decode_tier \
                    or got["all"] != got["q4_matmul_decode"] + got["q4_matmul_wgmma"]:
                fail(f"{label}: the {name} tier's int4 launches {got}")
        print(f"{label}: int4 matmul launches by tier since the warm-ups {launches} (a decode tier never prefills: "
              "the decode design alone)", flush=True)

        # (c) failover: the decode tier holding a stream dies after 3 tokens.
        text = _long_text(99, 90)
        trace = disagg_trace(0xd0, 0)
        tp = {"traceparent": f"00-{trace}-{'ab' * 8}-01"}
        status, _, body = http(bases["mono"], "/v1/completions", {"prompt": text, "max_tokens": 48, "temperature": 0},
                               headers=tp)
        if status != 200:
            fail(f"{label} (c): the monolith's request -> {status} {body[:200]}")
        mono_finish = json.loads(body)["choices"][0]["finish_reason"]
        want = emitted(journey_of(bases["mono"], trace, f"{label} (c)")["events"])
        killed = []

        def kill_holder(n):
            if n == 3 and not killed:
                for name in ("decode1", "decode2"):
                    if json.loads(http(bases[name], "/loadz", timeout=30)[2])["active_slots"]:
                        children[name].proc.kill()
                        killed.append(name)
                        return

        migrations0 = {n: scrape(bases[n])["samples"].get("substratus_serve_migrations_in", 0)
                       for n in ("decode1", "decode2")}
        c = stream_times(bases["prefill"], {"prompt": text, "max_tokens": 48, "temperature": 0}, tp,
                         on_chunk=kill_holder)
        if not killed:
            fail(f"{label} (c): no decode tier held the stream")
        survivor = "decode2" if killed[0] == "decode1" else "decode1"
        journey = journey_of(bases["prefill"], trace, f"{label} (c)")
        seg = journey["segments"][-1]
        recv = next(e[2] for e in seg["events"] if e[1] == "kv_recv")
        head = recv["prompt_tokens"] - (len(text) + 1)  # tokens streamed before the loss
        tail = emitted(seg["events"])
        moved = scrape(bases[survivor])["samples"].get("substratus_serve_migrations_in", 0) - migrations0[survivor]
        if c["finish"] != mono_finish or len(c["times"]) != len(want) or tail != want[head:] or head < 3 \
                or "requeue" not in [e[1] for e in journey["events"]] or moved < 1:
            fail(f"{label} (c): finish {c['finish']}, {len(c['times'])} tokens, {head} before the loss, the "
                 f"survivor's {tail[:6]}... against the monolith's {want[head:head + 6]}..., {moved} migrations")
        print(f"{label} (c) [{card}]: {killed[0]} killed after 3 streamed tokens ({head} reached the client); the "
              f"request was requeued and {survivor} ({int(moved)} migration) streamed the other {len(tail)}, "
              f"each the monolith's; the client's stream whole, {len(want)} tokens, finish {mono_finish}", flush=True)

        # Inter-token gaps of 6 streams while two 1500-token prompts arrive,
        # in turns; the pair has one decode tier left, as the monolith has
        # one engine.
        itl = {}
        for turn, name in enumerate(("mono", "prefill", "prefill", "mono")):
            itl.setdefault(name, []).append(itl_run(bases[name], f"{label} gaps", 9 + turn))
        for name, runs in itl.items():
            who = f"pair (decode tier {survivor})" if name == "prefill" else "monolith"
            print(f"{label} gaps [{card}]: {who}: 6 streams, two 1500-token prompts arriving: largest gap in the "
                  f"burst {[round(r['max_gap_ms'], 1) for r in runs]} ms, mean "
                  f"{[round(r['mean_gap_in_ms'], 1) for r in runs]} ms in it and "
                  f"{[round(r['mean_gap_out_ms'] or 0, 1) for r in runs]} ms outside, the burst answered in "
                  f"{[round(r['burst_s'], 2) for r in runs]} s", flush=True)

        lost = []

        def kill_last(n):
            if n == 3 and not lost:
                children[survivor].proc.kill()
                lost.append(time.perf_counter())

        d = stream_times(bases["prefill"], {"prompt": _long_text(99, 91), "max_tokens": 48, "temperature": 0},
                         on_chunk=kill_last)
        error_s = d["end"] - lost[0] if lost else None
        if not lost or d["finish"] != "error" or error_s > DISAGG_SHIP_TIMEOUT_S + 5:
            fail(f"{label} (c): with no decode tier left the stream ended {d['finish']} after {error_s} s")
        print(f"{label} (c): the last decode tier killed after 3 tokens: the stream ended \"error\" {error_s:.2f} s "
              f"later (bound {DISAGG_SHIP_TIMEOUT_S + 5:.0f} s)", flush=True)
    finally:
        for child in children.values():
            child.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    pair_launches = {k: sum(launches[n][k] for n in launches if n != "mono")
                     for k in ("q4_matmul_decode", "q4_matmul_wgmma", "q4_matmul")}
    print(f"{label}: {wall:.1f} s", flush=True)
    return {"ready_s": {n: c.ready_s for n, c in children.items()}, "digest": digest, "handoffs": rows,
            "pair_wall_s": pair_wall, "mono_wall_s": mono_wall, "transfer_mean_s": (t_sum1 - t_sum0) / max(sends, 1),
            "mixed": b_rows, "reference": reference, "ttft": ttft, "send_probe": probe, "gaps": itl,
            "tier_launches": launches,
            "launches": pair_launches, "failover": {"head": head, "killed": killed[0]}, "error_s": error_s,
            "seconds": wall}


# --- serve-w8a8: int8 weights x per-token int8 activations --------------------

# serve-int4's stack with w8a8 weights: the dense int8 cache, fused decode,
# the same prompts, so that its step sits beside serve-int4's.
W8A8_PARAMS = dict(INT4_PARAMS, quantize="w8a8")


def w8a8_counters() -> dict:
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_attention
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention
    from substratus_tpu_torch.ops.quant import w8a8_matmul, w8a8_quantize
    from substratus_tpu_torch.ops.quant4 import q4_matmul

    return {"w8a8_quantize": w8a8_quantize, "w8a8_matmul": w8a8_matmul, "q4_matmul": q4_matmul,
            "flash_fwd": flash_attention, "flash_cached": flash_cached_attention,
            "fused_decode": fused_decode_attention, "decode_attn": decode_attention}


def w8a8_turns(engine, label: str, steps: int = 16) -> dict:
    """On the stopped engine with every slot filled by 100-token prompts:
    the decode step's host clock (overlapped graph replays) with w8a8 and
    with weight-only int8 (quant_activations off: qeinsum's bf16 copy of
    each int8 weight) on the same int8 weights and slots, in turns w8a8,
    int8, int8, w8a8; each config captures its own graph before it is
    timed. The slots are released after."""
    import torch

    from substratus_tpu_torch.serve.engine import Request

    def decode(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine._step()
        engine._flush()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    b = engine.ec.max_batch
    for i in range(b):
        engine.queue.put(Request([256] + [65 + i] * 99, max_tokens=10_000, temperature=0.0))
    while not engine.active.all():
        if engine._admit() == 0:
            fail(f"{label}: admission failed")
    cfg = engine.cfg
    cfgs = {"w8a8": cfg, "int8": cfg.replace(quant_activations=False)}
    turns = {"w8a8": [], "int8": []}
    for mode in ("w8a8", "int8", "int8", "w8a8"):
        engine.cfg = cfgs[mode]
        decode(2)  # captures this config's graph when it changed
        turns[mode].append(decode(steps))
    engine.cfg = cfg
    for slot in range(b):
        engine._release_slot(slot)
    print(f"{label} [{card_line()}]: decode step at B={b}, ms, in turns (each config's own graph): "
          + "; ".join(f"{mode} {', '.join(f'{t:.2f}' for t in ts)}" for mode, ts in turns.items())
          + " (int8: the same int8 weights weight-only, a bf16 copy of each a call)", flush=True)
    return turns


def serve_w8a8_phase(card: str, profile_steps: bool = False) -> dict:
    """quantize: w8a8 through serve.main at llama2-7b's full width and
    depth: serve-int4's params and prompts with int8 weights and per-token
    int8 activations. Every projection but wo, and the lm_head, of every
    forward launches the quantize kernel and the s8 matmul once ((6 x 32 +
    1) x forwards); wo stays weight-only, as in JAX. The served greedy
    tokens are held against a single-shot w8a8 forward (5% rule) and the
    eager synchronous step token for token; the step beside weight-only
    int8 on the same weights, in turns."""
    import torch

    from substratus_tpu_torch.ops.quant import QTensor

    _free_card()
    server, engine, base = start_server("serve-w8a8", W8A8_PARAMS)
    params, cfg = engine.params, engine.cfg
    nbytes = {"weights": sum(t.numel() * t.element_size() for t in params.state_dict().values()
                             if isinstance(t, torch.Tensor)),
              "cache": sum(t.numel() * t.element_size() for t in engine.cache.values()),
              "allocated": torch.cuda.memory_allocated(), "peak_while_building": torch.cuda.max_memory_allocated()}
    print(f"serve-w8a8: bytes on the card: {nbytes['weights']} of weights (int8 projections and lm_head, bf16 "
          f"tok_embed and norms), {nbytes['cache']} of int8 cache, {nbytes['allocated']} allocated in all; peak "
          f"{nbytes['peak_while_building']} while the bf16 weights were quantized", flush=True)
    if not (cfg.quant_activations and isinstance(params.layers[0].wq, QTensor) and isinstance(params.lm_head, QTensor)):
        fail(f"serve-w8a8: not w8a8: quant_activations {cfg.quant_activations}, wq {type(params.layers[0].wq)}")
    L, per_forward = cfg.n_layers, 6 * cfg.n_layers + 1
    captured = engine._graph.captured
    if (captured.get("w8a8_quantize.launches"), captured.get("w8a8_matmul.launches")) != (per_forward, per_forward):
        fail(f"serve-w8a8: one replay holds {captured}, want {per_forward} launches of each w8a8 kernel")
    counters = w8a8_counters()
    requests = tee_requests(engine)
    try:
        zero_counts(engine, counters.values())
        results, wall = run_concurrent(base, INT4_PROMPTS)
        wait_idle(engine)
        launches = {name: launched(engine, c) for name, c in counters.items()}
        stats = dict(engine.stats)
    finally:
        server.stop()
    generated = check_usage(INT4_PROMPTS, results)
    del engine.submit
    check_graph_run(engine, stats, "serve-w8a8")
    forwards = stats["prefills"] + stats["prefill_chunks"] + stats["decode_steps"]
    want = {"w8a8_quantize": per_forward * forwards, "w8a8_matmul": per_forward * forwards, "q4_matmul": 0,
            "flash_fwd": L * stats["prefills"], "flash_cached": L * stats["prefill_chunks"],
            "fused_decode": L * stats["decode_steps"], "decode_attn": 0}
    if launches != want or stats["prefill_chunks"] != 3:
        fail(f"serve-w8a8: launches {launches} against {want}; stats {stats}")
    print(f"serve-w8a8: {forwards} forwards ({stats['prefills']} single-shot prefills, {stats['prefill_chunks']} "
          f"chunks, {stats['decode_steps']} decode steps, every step a graph replay), each {per_forward} launches of "
          f"the quantize kernel and {per_forward} of the s8 matmul (6 a layer + the lm_head; wo weight-only): "
          f"{launches}", flush=True)
    reference = long_reference_check(engine, [r for r in requests if r.temperature == 0.0], "serve-w8a8")
    eager = eager_check(engine, requests, "serve-w8a8")
    graph = graph_checks(engine, requests, "serve-w8a8")
    turns = w8a8_turns(engine, "serve-w8a8")
    profiled = profile_engine(engine, "profile-w8a8", (16, 1500)) if profile_steps else None
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    decode_tps = (generated - len(INT4_PROMPTS)) / stats["decode_seconds"]
    prefill_ms = 1e3 * stats["prefill_seconds"] / len(INT4_PROMPTS)
    ttft = results[-1][2]
    print(f"serve-w8a8 [{card}]: {len(INT4_PROMPTS)} concurrent requests, {generated} tokens in {wall:.2f} s; mean "
          f"prefill (engine) {prefill_ms:.1f} ms, decode {decode_tps:.1f} tokens/s, mean step {step_ms:.2f} ms "
          f"(overlapped, the step one CUDA graph), TTFT of the 1500-token request {ttft * 1e3:.1f} ms (client, "
          "streamed)", flush=True)
    return {"launches": launches, "stats": stats, "bytes": nbytes, "wall_s": wall, "generated": generated,
            "prefill_ms": prefill_ms, "decode_tokens_per_s": decode_tps, "step_ms": step_ms,
            "ttft_1500_ms": ttft * 1e3, "reference": reference, "eager_sync": eager, "graph": graph,
            "turns_ms": turns, "profile": profiled}


# --- rl: the actor-learner loop on one card -----------------------------------

RL_LAYERS = 4  # train-full's depth: the learner's weights, gradients and Adam state beside the actor's
RL_PROMPTS = 16
RL_TOKENS = 32
RL_ROUNDS = 3
RL_SEQ = 96  # prompts of 16-64 tokens + 32 generated


def rl_phase(card: str, profile_steps: bool = False) -> dict:
    """The RL loop (substratus_tpu_torch/rl/) at llama2-7b's width, 4
    layers, bf16, full finetuning: one actor engine (the default: overlapped,
    the paged pool, the step a CUDA graph) and the learner on one card; 16
    prompts, 32 tokens at temperature 0.9, 3 rounds, 2 updates a round
    (batch 8 x 96). Each round: every prompt an episode, no generation
    error, weights_version r + 1, finite losses, the actor's weights after
    the swap equal to the learner's snapshot, and a greedy probe through the
    actor within the 5% rule of a single-shot forward of those weights. The
    scheduler thread is never restarted and no graph is captured again.
    Each round's generation, learn, snapshot and swap seconds and the peak
    bytes are printed. With profile, one more round under torch.profiler."""
    import numpy as np
    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.rl import RLLearner, RLLoop
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.train.trainer import TrainConfig

    _free_card()
    cfg = llama.CONFIGS["llama2-7b"].replace(n_layers=RL_LAYERS)
    params = llama.init_params(cfg, seed=0, device="cuda")
    engine = Engine(cfg, params, EngineConfig(max_batch=RL_PROMPTS, max_seq_len=256, eos_token_id=2), device="cuda")
    if not (engine.overlap and engine.decode_graph and engine.paged):
        fail("rl: the actor must be the default engine (overlapped, paged, the step a graph)")
    engine.start()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, int(rng.integers(16, 65))).tolist() for _ in range(RL_PROMPTS)]
    probe = prompts[0][:24]
    engine.generate(probe, max_tokens=4, temperature=0.0)  # captures the step's graph
    thread, captures = engine._thread, engine.stats["graph_warmups"]
    learner = RLLearner(cfg, TrainConfig(lora_rank=0, learning_rate=2e-4, warmup_steps=1,
                                         total_steps=2 * RL_ROUNDS), params=params, device="cuda", batch_size=8,
                        seq_len=RL_SEQ)
    seconds = {"learn": [], "snapshot": [], "swap": []}
    snapshots = []

    def timed(key, fn, keep=None):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            seconds[key].append(time.perf_counter() - t0)
            if keep is not None:
                keep.append(out)
            return out
        return call

    learner.learn = timed("learn", learner.learn)
    learner.snapshot_params = timed("snapshot", learner.snapshot_params, snapshots)
    engine.swap_params = timed("swap", engine.swap_params)

    def reward(record, prompt_tokens):  # the share of completion tokens in the vocabulary's lower half
        toks = record.get("tokens") or []
        return sum(1 for t in toks if t < cfg.vocab_size // 2) / max(len(toks), 1)

    OUT_DIR.mkdir(exist_ok=True)
    out_dir = OUT_DIR / "rl"
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    loop = RLLoop([engine], learner, prompts, reward, str(out_dir), max_tokens=RL_TOKENS, temperature=0.9)
    reports, probes = [], []
    try:
        for rnd in range(RL_ROUNDS):
            rep = loop.run_round()
            reports.append(rep)
            if (rep["episodes"], rep["gen"]["errors"], rep["weights_version"], len(rep["losses"])) != (
                    RL_PROMPTS, 0, rnd + 1, 2) or not np.isfinite(rep["losses"]).all():
                fail(f"rl: round {rnd}: {rep}")
            served = engine.params.state_dict()
            if any(not torch.equal(served[k].cpu(), v) for k, v in snapshots[-1].items()):
                fail(f"rl: round {rnd}: the actor's weights are not the learner's snapshot after the swap")
            toks = engine.generate(probe, max_tokens=16, temperature=0.0)
            with torch.inference_mode():
                logits, _ = llama.forward(engine.params, torch.tensor([probe + toks[:-1]], device="cuda"), cfg)
            logits = logits[0, len(probe) - 1:]
            scale = logits.abs().max().item()
            gap = (logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]).max().item()
            agree = sum(int(logits[i].argmax()) == t for i, t in enumerate(toks))
            probes.append({"tokens": toks, "argmax_agree": agree, "max_gap": gap, "logit_scale": scale})
            if not torch.isfinite(logits).all() or gap > 0.05 * scale:
                fail(f"rl: round {rnd}: the probe's tokens disagree with the snapshot's single-shot forward "
                     f"{probes[-1]}")
        peak = torch.cuda.max_memory_allocated()
        if engine._thread is not thread or not thread.is_alive() or engine.error is not None:
            fail("rl: the actor's scheduler thread was restarted or died")
        if engine.stats["graph_warmups"] != captures:
            fail(f"rl: {engine.stats['graph_warmups'] - captures} graphs captured again across the swaps")
        profiled = None
        if profile_steps:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                extra = loop.run_round()
                wall = time.perf_counter() - t0
            profiled = _device_summary(prof, wall, 1)
            print(f"profile-rl: one more round {wall:.2f} s, device busy {profiled['device_busy_ms']:.1f} ms, "
                  f"losses {extra['losses']}", flush=True)
            for e in profiled["top"]:
                print(f"profile-rl: {e['ms']:8.3f} ms {e['calls']:6.1f} calls  {e['name'][:80]}", flush=True)
    finally:
        engine.stop()
    snap_bytes = sum(v.numel() * v.element_size() for v in snapshots[-1].values())
    for rnd, rep in enumerate(reports):
        print(f"rl [{card}]: round {rnd}: {rep['episodes']} episodes, {rep['gen']['gen_tokens']} tokens generated in "
              f"{rep['gen']['wall_s']:.2f} s ({rep['gen']['gen_tok_s']:.1f} tokens/s), mean reward "
              f"{rep['mean_reward']:.4f}; learn {seconds['learn'][rnd]:.2f} s (losses {rep['losses']}), snapshot "
              f"{seconds['snapshot'][rnd]:.2f} s and swap {seconds['swap'][rnd]:.2f} s for {snap_bytes} bytes; "
              f"weights_version {rep['weights_version']}; probe {probes[rnd]['argmax_agree']}/16 the argmax "
              f"(largest gap {probes[rnd]['max_gap']:.4g} at logit scale {probes[rnd]['logit_scale']:.4g})",
              flush=True)
    print(f"rl: llama2-7b width at {RL_LAYERS} layers, one actor and the learner on the card: {RL_ROUNDS} rounds, "
          f"versions {[r['weights_version'] for r in reports]}, the scheduler thread never restarted, no graph "
          f"captured again ({captures} captures); peak {peak} bytes ({peak / 2**30:.1f} GiB)", flush=True)
    return {"rounds": reports,
            "seconds": seconds, "probes": probes, "peak_bytes": peak, "snapshot_bytes": snap_bytes,
            "captures": captures, "profile": profiled}


# --- serve-gang: a tensor-parallel gang of two ranks on the card ---------------

GANG_LAYERS = 4  # llama2-7b's width; legs (a)-(c) and (e)'s depth, printed
GANG_NEW = 64
GANG_LENS = [64, 180, 333, 500, 700, 950, 1200, 1500]  # the 1500-token prompt runs as 3 chunks of 512
GANG_PARAMS = {"tensor": 2, "kv_layout": "dense", "max_batch": 8, "max_seq_len": 2048, "drain_grace": 30}
GANG_C_PARAMS = {"tensor": 2, "quantize": "int8", "max_batch": 8, "max_seq_len": 2048}  # kv_layout auto: paged
GANG_PREFIX = "System: " + _long_text(399, 7)  # (c)'s shared prefix, 25 full pages
GANG_SAMPLED = 3  # (b)'s sampled row
# (d): examples/llama2-70b/server.yaml's params with tensor 2 for 16 (the
# card holds four ranks, not sixteen); max_seq_len is serve.main's default.
GANG_70B_LAYERS = 1  # llama2-70b's width; (d)'s depth, printed (2 until legs (f)-(i) joined)
GANG_70B_PARAMS = {"quantize": "int4", "kv_cache_dtype": "int8", "max_batch": 32, "tensor": 2}
GANG_70B_SEQ = 1024  # serve.main's max_seq_len when params.json names none
GANG_70B_NEW = 48
GANG_70B_PREFIX = "System: " + _long_text(247, 11)  # 256 tokens with the BOS: 16 full pages
# (tokens, shares the prefix) in submission order: the prefix prompts first,
# so the balanced slots put them on both data replicas
GANG_70B_PROMPTS = [(300, True), (450, True), (600, True), (750, True), (64, False), (180, False), (880, False),
                    (960, False)]


class GangChild:
    """One rank of serve.main under the operator's gang environment in a
    child process, its output in OUT_DIR/serve_gang_{name}.log."""

    def __init__(self, name: str, params: dict, rank: int, coord: int, world: int = 2):
        OUT_DIR.mkdir(exist_ok=True)
        self.name, self.rank = name, rank
        path = OUT_DIR / f"chip_smoke_params_serve-gang-{name}.json"
        path.write_text(json.dumps(params))
        self.log = (OUT_DIR / f"serve_gang_{name}{rank}.log").open("w")
        self.lines = []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", "substratus_tpu_torch.serve.main", "--params", str(path),
                                      "--model", str(params["model"]), "--host", "127.0.0.1", "--port", "0"],
                                     cwd=Path(__file__).resolve().parent, env=gang_env(coord, world, rank),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.log.write(line)
            self.log.flush()
            self.lines.append(line)

    def wait_line(self, prefix: str, timeout: float = 180) -> str:
        while not any(ln.startswith(prefix) for ln in self.lines):
            if self.proc.poll() is not None or time.perf_counter() - self.t0 > timeout:
                fail(f"serve-gang: rank {self.rank} ({self.name}) did not start: {''.join(self.lines[-20:])}")
            time.sleep(0.1)
        self.ready_s = time.perf_counter() - self.t0
        return next(ln for ln in self.lines if ln.startswith(prefix))

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.reader.join(timeout=10)
        self.log.close()


def start_gang(name: str, params: dict) -> tuple:
    """Both ranks of a serve.main gang; (children, the leader's base URL,
    its startup line, the follower's)."""
    coord = free_port()
    children = [GangChild(name, params, r, coord) for r in range(2)]
    try:
        lead = children[0].wait_line("serving ")
        follow = children[1].wait_line("gang follower ")
        base = f"http://127.0.0.1:{int(lead.split('127.0.0.1:')[1].split()[0])}"
        wait_ok(base, f"serve-gang ({name})")
        for want, line in (("rank 0/2 (leader), mesh tensor=2", lead),
                           ("rank 1/2 (follower), mesh tensor=2", follow)):
            if want not in line or "graph: off (gang)" not in line:
                fail(f"serve-gang ({name}): a startup line lacks {want!r} or the eager step: {line}")
    except BaseException:  # fail() too: no rank outlives this script
        for c in children:
            c.stop()
        raise
    return children, base, lead, follow


def gang_reference(model, cfg, prompts, tokens, label: str, max_seq_len: int = GANG_PARAMS["max_seq_len"]) -> dict:
    """The 5% near-tie rule of long_reference_check on each request's
    served tokens against a single-shot forward of the whole model in this
    process (one rank of nothing: the single process)."""
    from types import SimpleNamespace

    from substratus_tpu_torch.models import llama

    engine = SimpleNamespace(clipped_prompt=lambda p: p[-(max_seq_len - 1):], device=model.device,
                             model=llama, params=model, cfg=cfg)
    requests = [SimpleNamespace(prompt_tokens=p, out=SimpleNamespace(tokens=t)) for p, t in zip(prompts, tokens)]
    return long_reference_check(engine, requests, label, quiet=True)


def engine_turn(engine, prompts, sampled=None, new: int = GANG_NEW) -> dict:
    """All requests at once through an in-process engine: tokens, each
    request's time to first token (a reader thread a request), the mean
    decode step."""
    from substratus_tpu_torch.serve.engine import Request

    steps0, seconds0 = engine.stats["decode_steps"], engine.stats["decode_seconds"]
    reqs = [engine.submit(Request(list(p), max_tokens=new, temperature=0.8 if i == sampled else 0.0))
            for i, p in enumerate(prompts)]
    out = [None] * len(reqs)

    def read(i, req):
        toks, first = [], None
        while (tok := req.out.get(timeout=600)) is not None:
            first = first or time.perf_counter()
            toks.append(tok)
        out[i] = (toks, first - req.submit_ts)

    threads = [threading.Thread(target=read, args=(i, r)) for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    steps = engine.stats["decode_steps"] - steps0
    return {"tokens": [t for t, _ in out], "ttft_s": [s for _, s in out],
            "step_ms": 1e3 * (engine.stats["decode_seconds"] - seconds0) / max(steps, 1)}


def gang_env(coord: int, world: int, rank: int) -> dict:
    """The operator's gang environment of one rank, the checkout on the
    path."""
    import os

    return {**os.environ, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{coord}",
            "JAX_NUM_PROCESSES": str(world), "TPU_WORKER_ID": str(rank),
            "PYTHONPATH": str(Path(__file__).resolve().parent) + os.pathsep + os.environ.get("PYTHONPATH", "")}


def gang_worker_call(model_dir: Path, params, plans, label: str, tag: str, extra=(), world: int = 2,
                     timeout: float = 300) -> list:
    """tools/gang_worker.py as `world` ranks on the card over the
    checkpoint: `params` one leg's object (or a list of legs), `plans` its
    request plan (or one a leg); each rank's result."""
    coord = free_port()
    plan = OUT_DIR / f"serve_gang_plan_{tag}.json"
    plan.write_text(json.dumps(plans))
    procs, outs = [], []
    for rank in range(world):
        outs.append(OUT_DIR / f"serve_gang_worker_{tag}{rank}.json")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "substratus_tpu_torch.tools.gang_worker", "--model", str(model_dir),
             "--params", json.dumps(params), "--requests", str(plan), "--out", str(outs[-1]), "--timeout", "120",
             *extra],
            cwd=Path(__file__).resolve().parent, env=gang_env(coord, world, rank),
            stdout=(OUT_DIR / f"serve_gang_worker_{tag}{rank}.log").open("w"), stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if rcs != [0] * world:
        fail(f"{label}: gang_worker ranks exited {rcs} (logs in {OUT_DIR}/serve_gang_worker_{tag}*.log)")
    return [json.loads(o.read_text()) for o in outs]


def run_gang_workers(model_dir: Path, prompts, label: str, params=None, world: int = 2, new: int = GANG_NEW,
                     sampled=GANG_SAMPLED, tag: str = "b") -> list:
    """tools/gang_worker.py as `world` ranks on the card over the
    checkpoint and the prompts at once (one sampled row, unless None; (a)'s
    params unless given), the all-reduce probe first; each rank's
    result."""
    plan = {"concurrent": True, "requests": [{"prompt": p, "max_tokens": new,
                                              "temperature": 0.8 if i == sampled else 0.0}
                                             for i, p in enumerate(prompts)]}
    params = params or {k: v for k, v in GANG_PARAMS.items() if k != "drain_grace"}
    return gang_worker_call(model_dir, params, plan, label, tag, extra=("--probe-allreduce",), world=world)


def run_staggered(base: str, texts, tag: int, new_tokens: int, label: str, gap_s: float = 0.05) -> tuple:
    """run_traced's requests, each started gap_s after the one before (all
    in flight together), so that they board in submission order."""
    results = [None] * len(texts)

    def one(i, text):
        tp = {"traceparent": f"00-{disagg_trace(tag, i)}-{'ab' * 8}-01"}
        results[i] = http(base, "/v1/completions", {"prompt": text, "max_tokens": new_tokens, "temperature": 0},
                          headers=tp)

    threads = [threading.Thread(target=one, args=(i, t)) for i, t in enumerate(texts)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
        time.sleep(gap_s)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for i, (status, _, text) in enumerate(results):
        if status != 200 or not json.loads(text)["usage"]["completion_tokens"]:
            fail(f"{label}: request {i} -> {status} {text[:200]}")
    return [journey_of(base, disagg_trace(tag, i), label) for i in range(len(texts))], wall


def gang_70b_leg(card: str, tmp: Path) -> dict:
    """(d): the llama2-70b example's gang as written, four serve.main ranks
    of data=2 x tensor=2 on the card, then four gang_worker ranks in turns
    with a single process (the phase's docstring)."""
    import statistics

    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    label = "serve-gang (d)"
    t_leg = time.perf_counter()
    cfg = llama.CONFIGS["llama2-70b"].replace(n_layers=GANG_70B_LAYERS)
    model = llama.init_params(cfg, seed=0, device="cuda")
    model_dir = tmp / "llama2-70b"
    write_hf(str(model_dir), model)
    llama.quantize_weights(model, "int4")  # the bytes each rank quantizes whole a layer, then slices
    _free_card()
    print(f"{label}: llama2-70b at {GANG_70B_LAYERS} of its 80 layers (full width: dim 8192, 64 heads, 8 kv heads, "
          f"hidden 28672, vocab 32000), seed 0, written as an HF directory in {time.perf_counter() - t_leg:.1f} s; "
          f"examples/llama2-70b/server.yaml's params {GANG_70B_PARAMS} (tensor 2 for its 16) on four ranks of the "
          "one card", flush=True)
    tok = ByteTokenizer()
    texts = [(GANG_70B_PREFIX + _long_text(n - 257, 150 + i)) if shared else _long_text(n - 1, 150 + i)
             for i, (n, shared) in enumerate(GANG_70B_PROMPTS)]
    prompts = [tok.encode(t) for t in texts]
    coord = free_port()
    children = [GangChild("d", {**GANG_70B_PARAMS, "model": str(model_dir)}, r, coord, world=4) for r in range(4)]
    try:
        lead = children[0].wait_line("serving ")
        for c in children[1:]:
            c.wait_line("gang follower ")
        mesh_lines = [c.wait_line("serving mesh:").strip() for c in children]
        if mesh_lines != ["serving mesh: data=2 tensor=2"] * 4 or "rank 0/4 (leader), mesh data=2 tensor=2" not in lead \
                or "weights int4:" not in lead:
            fail(f"{label}: startup lines {mesh_lines} / {lead}")
        base = f"http://127.0.0.1:{int(lead.split('127.0.0.1:')[1].split()[0])}"
        wait_ok(base, label)
        print(f"{label}: four ranks ready in {', '.join(f'{c.ready_s:.1f}' for c in children)} s; leader: "
              f"{lead.split('; gang: ')[1].strip()}", flush=True)
        # The prefix's pages, written on every replica (each runs every
        # prefill of the paged pool), before the requests that share them.
        http(base, "/v1/completions", {"prompt": GANG_70B_PREFIX + " warm up", "max_tokens": 2, "temperature": 0})
        time.sleep(0.5)
        counts0 = surface_launches(scrape(base))
        journeys, wall = run_staggered(base, texts, 0x9d, GANG_70B_NEW, label)
        counts1 = surface_launches(scrape(base))
        served = [emitted(j["events"]) for j in journeys]
        reference = gang_reference(model, cfg, prompts, served, label, max_seq_len=GANG_70B_SEQ)
        delta = {k: counts1.get(k, 0) - counts0.get(k, 0) for k in counts1}
        launches = {"q4_matmul_decode_70b": delta.get("q4_matmul.launches_decode", 0),
                    "q4_matmul_wgmma_70b": delta.get("q4_matmul.launches_wgmma", 0)}
        per_forward = 7 * GANG_70B_LAYERS + 1
        if min(launches.values()) <= 0 or delta.get("q4_matmul.launches", 0) % per_forward or \
                delta.get("q4_matmul.launches_mma", 0):
            fail(f"{label}: the leader's int4 launches {delta}")
        slots = [next(e[2]["slot"] for e in j["events"] if e[1] == "admit") for j in journeys]
        hits = [sum(e[2]["tokens"] for e in j["events"] if e[1] == "prefix_hit") for j in journeys]
        per = GANG_70B_PARAMS["max_batch"] // 2
        hit_replicas = {s // per for s, h in zip(slots, hits) if h}
        if hit_replicas != {0, 1}:
            fail(f"{label}: prefix hits {hits} at slots {slots}: not on both data replicas")
        exact = sum(r["argmax_agree"] for r in reference["requests"])
        total = sum(r["tokens"] for r in reference["requests"])
        print(f"{label} [{card}]: {len(texts)} requests of {min(len(p) for p in prompts)}-{max(len(p) for p in prompts)} "
              f"tokens, {GANG_70B_NEW} new each, in {wall:.2f} s; {exact}/{total} served tokens the single process's "
              f"argmax, every one within the near-tie rule; slots {slots}, prefix-hit tokens {hits} (both data "
              f"replicas); the leader's int4 launches {launches} ({per_forward} a forward)", flush=True)
        timeout_s = int(lead.split("collective timeout ")[1].split()[0])
        t_kill = time.perf_counter()
        children[2].proc.kill()  # rank 2: data replica 1
        try:
            rc = children[0].proc.wait(timeout=timeout_s + 60)
        except subprocess.TimeoutExpired:
            fail(f"{label}: the leader still runs {timeout_s + 60} s after rank 2's SIGKILL")
        waited = time.perf_counter() - t_kill
        if rc == 0 or waited > timeout_s:
            fail(f"{label}: after rank 2's SIGKILL the leader exited {rc} in {waited:.1f} s (timeout {timeout_s} s)")
        print(f"{label}: rank 2 (data replica 1) SIGKILLed: the leader exited {rc} after {waited:.1f} s (its collective "
              f"timeout {timeout_s} s)", flush=True)
    finally:
        for c in children:
            c.stop()
    # The numbers: four gang_worker ranks in turns with a single process.
    single = Engine(cfg, model, EngineConfig(max_batch=GANG_70B_PARAMS["max_batch"], max_seq_len=GANG_70B_SEQ,
                                             kv_cache_dtype="int8"), device="cuda")
    single.start()
    try:
        engine_turn(single, prompts[:1], new=2)  # the graph's capture
        turn1 = engine_turn(single, prompts, new=GANG_70B_NEW)
        ranks = run_gang_workers(model_dir, prompts, label, params={**GANG_70B_PARAMS, "max_seq_len": GANG_70B_SEQ},
                                 world=4, new=GANG_70B_NEW, sampled=None, tag="d")
        turn2 = engine_turn(single, prompts, new=GANG_70B_NEW)
    finally:
        single.stop()
    got = [q["tokens"] for q in ranks[0]["requests"]]
    if any([q["tokens"] for q in r["requests"]] != got for r in ranks[1:]) or any(r["error"] for r in ranks):
        fail(f"{label}: the worker ranks' tokens differ or an engine failed: {[r['error'] for r in ranks]}")
    ref_w = gang_reference(model, cfg, prompts, got, label + " workers", max_seq_len=GANG_70B_SEQ)
    lead_r = ranks[0]
    ar = lead_r["allreduce_s"]
    step = 1e3 * lead_r["stats"]["decode_seconds"] / lead_r["stats"]["decode_steps"]
    ttft = [q["ttft_s"] for q in lead_r["requests"]]
    exchange = statistics.median(lead_r["exchange_s"])
    int32_key, max_key = f"16x1x{cfg.dim}_int32", "16x1x1_float32_max"
    print(f"{label} [{card}]: four gang_worker ranks' {sum(len(t) for t in got)} tokens equal, every one within the "
          f"rule; the token exchange over the data group (gloo, [32] int64) median {1e3 * exchange:.3f} ms a step "
          f"(the probe's {1e3 * ar['32_int64']:.3f} ms); the tensor group's all-reduce of a w8a8 w_down's s32 "
          f"partials [16,1,{cfg.dim}] int32 {1e3 * ar[int32_key]:.3f} ms, its rows' amax (MAX, f32) "
          f"{1e3 * ar[max_key]:.3f} ms, bf16 [8,1,{cfg.dim}] {1e3 * ar[f'8x1x{cfg.dim}']:.3f} ms, [1,512,{cfg.dim}] "
          f"{1e3 * ar[f'1x512x{cfg.dim}']:.3f} ms (medians of 50)", flush=True)
    print(f"{label} [{card}]: in turns (single, gang, single; 8 requests at once, {GANG_70B_NEW} new each): mean "
          f"decode step {turn1['step_ms']:.2f} / {step:.2f} / {turn2['step_ms']:.2f} ms (the single process's step "
          f"one CUDA graph, the gang's eager); mean TTFT {1e3 * statistics.mean(turn1['ttft_s']):.1f} / "
          f"{1e3 * statistics.mean(ttft):.1f} / {1e3 * statistics.mean(turn2['ttft_s']):.1f} ms; peak memory "
          + ", ".join(f"rank {r['rank']} {r['peak_memory_bytes']} bytes" for r in ranks)
          + f" (the single process {torch.cuda.max_memory_allocated()} bytes); leg {time.perf_counter() - t_leg:.1f} s",
          flush=True)
    del model, single
    _free_card()
    return {"layers": GANG_70B_LAYERS, "launches": launches, "reference": reference, "reference_workers": ref_w,
            "slots": slots, "prefix_hit_tokens": hits, "kill_exit": rc, "kill_seconds": waited,
            "allreduce_s": ar, "exchange_median_s": exchange,
            "step_ms": {"single": [turn1["step_ms"], turn2["step_ms"]], "gang": step},
            "ttft_s": {"single": [turn1["ttft_s"], turn2["ttft_s"]], "gang": ttft},
            "peak_bytes": [r["peak_memory_bytes"] for r in ranks], "seconds": time.perf_counter() - t_leg}


def gang_w8a8_leg(card: str, ranks, model, cfg, prompts) -> dict:
    """(e): the w8a8 leg of gang_rest_legs' call (`ranks`, each rank's
    result): two gang_worker ranks at llama2-7b's width, tensor=2, w8a8,
    the dense cache, 8 rows, one sampled; `model` holds the int8 weights
    (c) quantized, the single process's w8a8 weights."""
    label = "serve-gang (e)"
    got = [q["tokens"] for q in ranks[0]["requests"]]
    if got != [q["tokens"] for q in ranks[1]["requests"]] or any(r["error"] for r in ranks):
        fail(f"{label}: the ranks' tokens differ or an engine failed: {[r['error'] for r in ranks]}")
    greedy = [i for i in range(len(prompts)) if i != GANG_SAMPLED]
    ref = gang_reference(model, cfg.replace(quant_activations=True), [prompts[i] for i in greedy],
                         [got[i] for i in greedy], label)
    counts = ranks[0]["launches"]
    rows = counts.get("w8a8_quantize.launches_amax", 0)
    if rows <= 0 or rows != counts.get("w8a8_quantize.launches_scaled") or rows % cfg.n_layers:
        fail(f"{label}: the row-parallel quantize's launches {counts}")
    int32 = ranks[0]["allreduce_s"][f"16x1x{cfg.dim}_int32"]
    print(f"{label} [{card}]: w8a8 at tensor=2 ({ranks[0]['startup'].split('; weights ')[1].split(';')[0]}): both "
          f"ranks' {sum(len(t) for t in got)} tokens equal, the sampled row's too; every greedy token within the "
          f"rule of a single-process w8a8 forward; w_down's row-parallel quantize {rows} launches of each mode on "
          f"the leader ({rows // cfg.n_layers} forwards); the int32 all-reduce [16,1,{cfg.dim}] median "
          f"{1e3 * int32:.3f} ms; peak memory {[r['peak_memory_bytes'] for r in ranks]} bytes", flush=True)
    return {"reference": ref, "launches": {"w8a8_quantize_rows": rows}, "int32_allreduce_s": int32,
            "peak_bytes": [r["peak_memory_bytes"] for r in ranks]}


# (f)-(i): the rest of serving in a gang, two ranks of tensor=2 at
# GANG_LAYERS of llama2-7b. (f): examples/llama2-7b/server-throughput.yaml's
# params (int4, int8 cache, B=24, prompt lookup k=3) on the paged pool as
# written, through serve.main over HTTP, then on the dense cache; (g) a
# self-draft (the target's own checkpoint, its proposals accepted) on bf16
# pages through serve.main, then a draft at tinyllama-1.1b's width and
# GANG_DRAFT_LAYERS layers (2 kv heads a rank); (h) three seeded tenants of
# rank 16 with a store of capacity 2, a third hot-loaded mid-run: bf16 pages
# through serve.main, then int4 on the dense cache. The second of each, (b)
# and (e) run in one gang_worker call, which also reads the follower's tokens
# and store. (i) examples/batch-generation's params through serve.batchgen
# as a gang.
GANG_SPEC_PARAMS = {"tensor": 2, "quantize": "int4", "kv_cache_dtype": "int8", "max_batch": 24, "spec_k": 3,
                    "max_seq_len": 1024}
GANG_SPEC_NEW = 48
GANG_DRAFT_LAYERS = 2
GANG_DRAFT_PARAMS = {"tensor": 2, "max_batch": 8, "spec_k": 4, "max_seq_len": 1024}
GANG_TENANT_RANK = 16
GANG_TENANT_PARAMS = {"tensor": 2, "max_batch": 8, "max_seq_len": 1024,
                      "adapters": {"capacity": 2, "rank": GANG_TENANT_RANK}}
GANG_TENANT_NEW = 32
# (prompt index, tenant, after): t2 boards once the first t0 request ended (a hot load, an eviction)
GANG_TENANT_PLAN = [(0, None, None), (1, "t0", None), (1, "t1", None), (2, "t0", None), (3, None, None),
                    (4, "t2", 1)]
GANG_BATCH_PARAMS = {"quantize": "int8", "max_batch": 16, "tensor": 2}  # examples/batch-generation, tensor 2
GANG_BATCH_RECORDS = 32
GANG_BATCH_NEW = 32


def spec_rows(ranks, leg: int, label: str) -> list:
    """The leg's rows, every rank's equal (sampled rows too), no error."""
    rows = [q["tokens"] for q in ranks[0]["legs"][leg]["requests"]]
    for r in ranks:
        got = r["legs"][leg]
        if [q["tokens"] for q in got["requests"]] != rows or got["error"] is not None:
            fail(f"{label}: rank {r['rank']}'s tokens differ from the leader's or its engine failed: {got['error']}")
    return rows


def gang_http_leg(name: str, params: dict, items, tag: int, label: str, want: str) -> tuple:
    """One serve.main gang of two ranks (start_gang) serving `items` over
    HTTP (post_traced), both startup lines naming `want`; (tokens,
    responses, the leader's /metrics samples and kernel launches, its
    startup line, the wall seconds), both ranks stopped."""
    children, base, lead, follow = start_gang(name, params)
    try:
        for line in (lead, follow):
            if want not in line:
                fail(f"{label}: a startup line lacks {want!r}: {line}")
        journeys, bodies, wall = post_traced(base, items, tag, label)
        metrics = scrape(base)
        status, _, models = http(base, "/v1/models")
    finally:
        for c in children:
            c.stop()
    if status != 200:
        fail(f"{label}: /v1/models -> {status} {models[:200]}")
    prefix = "substratus_serve_"
    stats = {k[len(prefix):]: v for k, v in metrics["samples"].items() if k.startswith(prefix) and "{" not in k}
    read = {"stats": stats, "launches": surface_launches(metrics), "models": json.loads(models)}
    return [emitted(j["events"]) for j in journeys], bodies, read, lead, wall


def gang_rest_legs(card: str, tmp: Path, model_dir: Path, model, cfg, prompts) -> tuple:
    """(f), (g), (h): three serve.main gangs over HTTP and one gang_worker
    call of their second legs, (b)'s leg and (e)'s w8a8 leg on (b)'s
    `prompts` (one call: one start of its ranks), held by the near-tie rule
    against single-process forwards on the same bytes, (f)'s paged round in
    turns with a single-process spec engine (the phase's docstring).
    Returns (the report, each rank's (b) leg, each rank's (e) leg for
    gang_w8a8_leg)."""
    import copy
    from types import SimpleNamespace

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve.adapters import save_adapter_artifact
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
    from substratus_tpu_torch.tools.ckpt_writer import write_hf
    from substratus_tpu_torch.tools.gang_worker import seeded_tenants

    label = "serve-gang (f)-(h)"
    t0 = time.perf_counter()
    tok = ByteTokenizer()
    L = cfg.n_layers
    dcfg = llama.CONFIGS["tinyllama-1.1b"].replace(n_layers=GANG_DRAFT_LAYERS)
    draft = llama.init_params(dcfg, seed=1, device="cuda")
    write_hf(str(tmp / "draft"), draft)
    del draft
    tenants = seeded_tenants(cfg, 3, GANG_TENANT_RANK)
    for aid, layers in tenants.items():
        save_adapter_artifact(str(tmp / "tenants" / aid), layers, 2.0 * GANG_TENANT_RANK, GANG_TENANT_RANK)
    tenant_params = {**GANG_TENANT_PARAMS, "adapters": {**GANG_TENANT_PARAMS["adapters"], "dir": str(tmp / "tenants")}}
    model4 = copy.deepcopy(model)
    llama.quantize_weights(model4, "int4")  # the bytes each rank quantizes whole, then slices
    spec_ids = [tok.encode(text) for text, *_ in SPEC_PROMPTS]
    spec_temps = [temp for _, _, temp, _ in SPEC_PROMPTS]
    spec_items = [{"prompt": text, "max_tokens": GANG_SPEC_NEW, "temperature": temp}
                  for text, _, temp, _ in SPEC_PROMPTS]
    spec_plan = {"concurrent": True, "requests": [{"prompt": p, "max_tokens": GANG_SPEC_NEW, "temperature": t}
                                                  for p, t in zip(spec_ids, spec_temps)]}
    draft_ids = [tok.encode(text) for text, *_ in DRAFT_PROMPTS]
    draft_temps = [temp for _, _, temp, _ in DRAFT_PROMPTS]
    draft_items = [{"prompt": text, "max_tokens": 32, "temperature": temp} for text, _, temp, _ in DRAFT_PROMPTS]
    draft_plan = {"concurrent": True, "requests": [{"prompt": p, "max_tokens": 32, "temperature": t}
                                                   for p, t in zip(draft_ids, draft_temps)]}
    tenant_texts = [_long_text(30 + 70 * i, 170 + i) for i in range(5)]
    tenant_ids = [tok.encode(t) for t in tenant_texts]
    tenant_items = [{"prompt": tenant_texts[i], "max_tokens": GANG_TENANT_NEW, "temperature": 0.0,
                     **({"model": ad} if ad else {}), **({"after": after} if after is not None else {})}
                    for i, ad, after in GANG_TENANT_PLAN]
    tenant_plan = {"concurrent": True, "requests": [
        {"prompt": tenant_ids[i], "max_tokens": GANG_TENANT_NEW, **({"adapter": ad} if ad else {}),
         **({"after": after} if after is not None else {})} for i, ad, after in GANG_TENANT_PLAN]}
    b_plan, w8a8_plan = ({"concurrent": True, "requests": [{"prompt": p, "max_tokens": new,
                                                            "temperature": 0.8 if i == GANG_SAMPLED else 0.0}
                                                           for i, p in enumerate(prompts)]} for new in (GANG_NEW, 32))
    b_params = {k: v for k, v in GANG_PARAMS.items() if k != "drain_grace"}
    legs = [b_params, {**GANG_SPEC_PARAMS, "kv_layout": "dense"},
            {**GANG_DRAFT_PARAMS, "draft_model": str(tmp / "draft")},
            {**tenant_params, "quantize": "int4", "kv_layout": "dense", "kv_cache_dtype": "int8"},
            {**b_params, "quantize": "w8a8"}]
    plans = [b_plan, spec_plan, draft_plan, tenant_plan, w8a8_plan]
    greedy = [i for i, t in enumerate(spec_temps) if t == 0.0]
    single = Engine(cfg, model4, EngineConfig(max_batch=24, max_seq_len=1024, kv_cache_dtype="int8", spec_k=3),
                    device="cuda")
    single.start()
    try:
        engine_turn(single, spec_ids[:2], new=8)  # the width graphs' captures
        turn1 = engine_turn(single, [spec_ids[i] for i in greedy], new=GANG_SPEC_NEW)
        f_rows, _, f_read, f_line, f_wall = gang_http_leg(
            "f", {**GANG_SPEC_PARAMS, "model": str(model_dir)}, spec_items, 0x9f, "serve-gang (f) paged",
            "speculation prompt-lookup k=3, eager rounds")
        turn2 = engine_turn(single, [spec_ids[i] for i in greedy], new=GANG_SPEC_NEW)
        single_stats = dict(single.stats)
    finally:
        single.stop()
    del single
    _free_card()
    g_rows, _, g_read, g_line, _ = gang_http_leg(
        "g", {**GANG_DRAFT_PARAMS, "model": str(model_dir), "draft_model": str(model_dir)}, draft_items, 0x96,
        "serve-gang (g) self-draft", f"speculation draft={model_dir} k=4 ({cfg.n_heads // 2} heads, "
                                     f"{cfg.n_kv_heads // 2} kv heads a rank), eager rounds")
    h_rows, h_bodies, h_read, h_line, _ = gang_http_leg(
        "h", {**tenant_params, "model": str(model_dir)}, tenant_items, 0x98, "serve-gang (h) bf16 pages",
        f"adapter store capacity 2, rank {GANG_TENANT_RANK}, this rank's slice of each tenant")
    ranks = gang_worker_call(model_dir, legs, plans, label, "f", world=2, timeout=420, extra=("--probe-allreduce",))
    out = {"launches": {}}

    # (f): the lookup legs, paged through serve.main, dense through gang_worker.
    lab = "serve-gang (f) paged"
    st, launches = f_read["stats"], f_read["launches"]
    if st["verify_passes"] <= 0 or st["spec_proposed"] <= 0:
        fail(f"{lab}: no verify pass wider than one token: {st}")
    ref = gang_reference(model4, cfg, [spec_ids[i] for i in greedy], [f_rows[i] for i in greedy], lab,
                         max_seq_len=1024)
    wgmma = launches.get("q4_matmul.launches_wgmma", 0)
    if wgmma <= 0 or launches.get("q4_matmul.launches_mma", 0):
        fail(f"{lab}: the int4 launches {launches}")
    out["launches"]["q4_matmul_wgmma_verify_tp2"] = wgmma
    round_ms = 1e3 * st["decode_seconds"] / st["decode_steps"]
    out["paged"] = {"reference": ref, "stats": st, "round_ms": round_ms, "launches": launches, "wall_s": f_wall,
                    "acceptance": st["spec_accepted"] / st["spec_proposed"]}
    widths = {k: int(v) for k, v in st.items() if k.startswith("rounds_w") and v}
    print(f"{lab} [{card}]: the throughput example's params (int8 pages, B=24, lookup k=3) through two serve.main "
          f"ranks of tensor=2 ({f_line.split('; gang: ')[1].split(';')[0]}), {len(spec_items)} requests at once over "
          f"HTTP in {f_wall:.2f} s; {int(st['verify_passes'])} verify passes of {int(st['decode_steps'])} rounds "
          f"{widths}, accepted {int(st['spec_accepted'])}/{int(st['spec_proposed'])} proposals; the round's host "
          f"clock {round_ms:.2f} ms (eager, two ranks time-slicing the card); int4 wgmma launches {wgmma}", flush=True)
    lab = "serve-gang (f) dense"
    rows = spec_rows(ranks, 1, lab)
    lead = ranks[0]["legs"][1]
    st, launches = lead["stats"], lead["launches"]
    if st["verify_passes"] <= 0 or st["spec_proposed"] <= 0:
        fail(f"{lab}: no verify pass wider than one token: {st}")
    ref = gang_reference(model4, cfg, [spec_ids[i] for i in greedy], [rows[i] for i in greedy], lab,
                         max_seq_len=1024)
    cached = launches.get("flash_cached_attention.launches_wgmma", 0)
    if cached != L * st["verify_passes"]:
        fail(f"{lab}: the cached flash launched {cached} times, want {L} x {st['verify_passes']} verify passes")
    out["launches"]["flash_cached_int8_verify_tp2"] = cached
    wgmma = launches.get("q4_matmul.launches_wgmma", 0)
    if wgmma <= 0 or launches.get("q4_matmul.launches_mma", 0):
        fail(f"{lab}: the int4 launches {launches}")
    out["launches"]["q4_matmul_wgmma_verify_tp2"] += wgmma
    round_ms = 1e3 * st["decode_seconds"] / st["decode_steps"]
    out["dense"] = {"reference": ref, "stats": st, "round_ms": round_ms, "launches": launches,
                    "acceptance": st["spec_accepted"] / st["spec_proposed"]}
    widths = {k: v for k, v in st.items() if k.startswith("rounds_w") and v}
    print(f"{lab} [{card}]: the same on the dense int8 cache through two gang_worker ranks: both ranks' "
          f"{sum(len(r) for r in rows)} tokens equal (the sampled rows too); {st['verify_passes']} verify passes of "
          f"{st['decode_steps']} rounds {widths}, accepted {st['spec_accepted']}/{st['spec_proposed']} proposals; the "
          f"round's host clock {round_ms:.2f} ms; int4 wgmma launches {wgmma}, the cached flash {cached} ({L} a verify "
          f"pass)", flush=True)
    print(f"serve-gang (f) [{card}]: in turns (single, gang, single; {len(greedy)} greedy requests at once, "
          f"{GANG_SPEC_NEW} new each, the gang's {len(spec_items)} with the sampled ones): the round's host clock "
          f"{turn1['step_ms']:.2f} / {out['paged']['round_ms']:.2f} / {turn2['step_ms']:.2f} ms (the single process's "
          f"rounds CUDA graphs, int8 pages; its acceptance {single_stats['spec_accepted']}/"
          f"{single_stats['spec_proposed']}); the width exchange: none at data=1 (the serve-gang-data phase runs "
          "data=2)", flush=True)
    out["single_round_ms"] = [turn1["step_ms"], turn2["step_ms"]]
    out["leg_launches"] = {"(f) paged": {k: v for k, v in out["paged"]["launches"].items() if v},
                           "(g) self-draft": {k: v for k, v in g_read["launches"].items() if v},
                           "(h) bf16 pages": {k: v for k, v in h_read["launches"].items() if v}}
    for leg, name in enumerate(("(f) dense", "(g) tinyllama", "(h) int4 dense"), start=1):
        out["leg_launches"][name] = {k: v for k, v in ranks[0]["legs"][leg]["launches"].items() if v}
    for name, counts in out["leg_launches"].items():
        print(f"serve-gang {name}: the leader's kernel launches {counts}", flush=True)

    # (g): the self-draft through serve.main, the tinyllama-width draft through gang_worker.
    dgreedy = [i for i, t in enumerate(draft_temps) if t == 0.0]
    lab = "serve-gang (g) self-draft"
    st = g_read["stats"]
    if st["verify_passes"] <= 0 or st["spec_accepted"] <= 0 or st["draft_prefill_chunks"] <= 0:
        fail(f"{lab}: no verify pass, no accepted proposal or no draft prefill: {st}")
    out["self_draft"] = {"reference": gang_reference(model, cfg, [draft_ids[i] for i in dgreedy],
                                                     [g_rows[i] for i in dgreedy], lab, max_seq_len=1024),
                         "stats": st, "round_ms": 1e3 * st["decode_seconds"] / st["decode_steps"]}
    print(f"{lab} [{card}]: bf16 pages, the target's own checkpoint as the draft through two serve.main ranks "
          f"(serve.main loads it and its gang_draft shards it: {cfg.n_heads // 2} heads a rank), k=4: "
          f"{int(st['verify_passes'])} verify passes, accepted {int(st['spec_accepted'])}/{int(st['spec_proposed'])}; "
          f"the round {out['self_draft']['round_ms']:.2f} ms; every greedy token within the rule", flush=True)
    lab = "serve-gang (g) tinyllama"
    rows = spec_rows(ranks, 2, lab)
    st = ranks[0]["legs"][2]["stats"]
    if st["verify_passes"] <= 0 or st["draft_prefill_chunks"] <= 0:
        fail(f"{lab}: the draft made no verify pass or prefilled nothing: {st}")
    out["draft"] = {"reference": gang_reference(model, cfg, [draft_ids[i] for i in dgreedy],
                                                [rows[i] for i in dgreedy], lab, max_seq_len=1024),
                    "stats": st, "round_ms": 1e3 * st["decode_seconds"] / st["decode_steps"]}
    print(f"{lab} [{card}]: bf16 pages, a draft at tinyllama-1.1b's width and {GANG_DRAFT_LAYERS} layers (seed 1, "
          f"{ranks[0]['legs'][2]['startup'].split('speculation ')[1].split(';')[0]}), k=4: both ranks' tokens equal; "
          f"{st['verify_passes']} verify passes, accepted {st['spec_accepted']}/{st['spec_proposed']}; the round "
          f"{out['draft']['round_ms']:.2f} ms", flush=True)

    # (h): the tenants, bf16 pages through serve.main, int4 dense through gang_worker.
    trees = {aid: plain_lora(layers, 2.0, "cuda", cfg.dtype) for aid, layers in tenants.items()}

    def tenant_reference(rows, weights, lab):
        if rows[1] == rows[2]:
            fail(f"{lab}: tenants t0 and t1 gave the same tokens on one prompt")
        eng = SimpleNamespace(clipped_prompt=lambda p: p[-1023:], device=weights.device, model=llama, params=weights,
                              cfg=cfg)
        reqs = [SimpleNamespace(prompt_tokens=tenant_ids[i], adapter=ad, out=SimpleNamespace(tokens=rows[j]))
                for j, (i, ad, _) in enumerate(GANG_TENANT_PLAN)]
        return adapter_reference(eng, reqs, trees, lab)

    lab = "serve-gang (h) bf16 pages"
    s = h_read["stats"]
    loaded = sorted(m["id"] for m in h_read["models"]["data"] if m.get("loaded"))
    evictions = s.get("adapter_evictions_total", 0)
    served_as = h_read["models"]["data"][0]["id"]  # the leader's model name
    if (s["adapter_requests"] != 4 or evictions < 1 or "t2" not in loaded
            or [b["model"] for b in h_bodies] != [ad or served_as for _, ad, _ in GANG_TENANT_PLAN]):
        fail(f"{lab}: admissions {s['adapter_requests']}, evictions {evictions}, loaded {loaded}, the responses' "
             f"models {[b['model'] for b in h_bodies]}")
    out["tenants_http"] = {"reference": tenant_reference(h_rows, model, lab), "evictions": evictions,
                           "loaded": loaded}
    print(f"{lab} [{card}]: base rows and tenants t0, t1 in one batch through two serve.main ranks (the `model` field "
          f"over HTTP), t2 hot-loaded once t0's first request ended ({int(evictions)} eviction, resident {loaded}); t0 "
          f"and t1 differ on one prompt; every token within the rule of the plain lora_delta", flush=True)
    lab = "serve-gang (h) int4, dense int8"
    rows = spec_rows(ranks, 3, lab)
    lead = ranks[0]["legs"][3]
    snap = lead["adapters"]
    if lead["stats"]["adapter_requests"] != 4 or snap["evictions"] < 1 or "t2" not in snap["loaded"]:
        fail(f"{lab}: the store's admissions {lead['stats']['adapter_requests']}, snapshot {snap}")
    if any(r["legs"][3]["adapters"] != snap for r in ranks):
        fail(f"{lab}: the ranks' stores differ")
    out["tenants_int4"] = {"reference": tenant_reference(rows, model4, lab), "store": snap}
    print(f"{lab} [{card}]: the same through two gang_worker ranks ({snap['evictions']} eviction, {snap['misses']} "
          f"miss): both ranks' tokens and stores equal, t0 and t1 differ on one prompt; weights "
          f"{lead['startup'].split('; weights ')[1].split(';')[0]}", flush=True)
    del model4
    _free_card()
    out["seconds"] = time.perf_counter() - t0
    print(f"{label}: {out['seconds']:.1f} s", flush=True)
    return out, [r["legs"][0] for r in ranks], [r["legs"][4] for r in ranks]


def gang_batchgen_leg(card: str, tmp: Path, model_dir: Path, model, cfg) -> dict:
    """(i) serve.batchgen as two ranks of tensor=2 (examples/batch-generation's
    params): the follower SIGKILLed mid-run fails the leader; the rerun
    resumes from the leader's shards; every record once, each within the
    near-tie rule of a single-process forward on the int8 bytes (`model`)."""
    from substratus_tpu_torch.load import manifest
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    label = "serve-gang (i)"
    t0 = time.perf_counter()
    tok = ByteTokenizer()
    recs = [{"id": f"g{i}", "prompt": _long_text(20 + 37 * i, 210 + i), "max_tokens": GANG_BATCH_NEW}
            for i in range(GANG_BATCH_RECORDS)]
    man, out_dir, params = tmp / "gang_manifest.jsonl", tmp / "gang_batch_out", tmp / "gang_batch_params.json"
    manifest.write_manifest(str(man), recs)
    params.write_text(json.dumps(GANG_BATCH_PARAMS))

    def start(floor_ms: int, tag: str) -> list:
        coord = free_port()
        return [subprocess.Popen(
            [sys.executable, "-m", "substratus_tpu_torch.serve.batchgen", "--manifest", str(man), "--output",
             str(out_dir), "--model", str(model_dir), "--params", str(params), "--step-floor-ms", str(floor_ms)],
            cwd=Path(__file__).resolve().parent, env=gang_env(coord, 2, r),
            stdout=(OUT_DIR / f"serve_gang_batchgen_{tag}{r}.log").open("w"), stderr=subprocess.STDOUT)
            for r in range(2)]

    procs = start(30, "a")
    try:
        deadline = time.perf_counter() + 240
        while not manifest.completed_indices(str(out_dir)):
            if time.perf_counter() > deadline or procs[0].poll() is not None:
                fail(f"{label}: the leader wrote no record (logs {OUT_DIR}/serve_gang_batchgen_a*.log)")
            time.sleep(0.02)
        procs[1].kill()
        t_kill = time.perf_counter()
        rc = procs[0].wait(timeout=180)
        waited = time.perf_counter() - t_kill
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    first = manifest.completed_indices(str(out_dir))
    if rc == 0 or len(first) >= len(recs):
        fail(f"{label}: after the follower's SIGKILL the leader exited {rc} with {len(first)} of {len(recs)} records")
    t_rerun = time.perf_counter()
    procs = start(0, "b")
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rerun_s = time.perf_counter() - t_rerun
    if rcs != [0, 0]:
        fail(f"{label}: the rerun's ranks exited {rcs} (logs {OUT_DIR}/serve_gang_batchgen_b*.log)")
    got = {}
    for path in manifest.list_shards(str(out_dir)):
        for line in open(path):
            try:
                r = json.loads(line)
            except ValueError:
                continue  # a torn tail
            got.setdefault(r["index"], []).append(r)
    if sorted(got) != list(range(len(recs))) or any(len(v) != 1 for v in got.values()) or any(
            v[0]["finish_reason"] not in ("length", "stop") or not v[0]["tokens"] for v in got.values()):
        fail(f"{label}: not every record written once with its tokens: {got}")
    lines = (OUT_DIR / "serve_gang_batchgen_b0.log").read_text().splitlines()
    summary = json.loads(next(ln for ln in reversed(lines) if ln.startswith('{"')))
    ref = gang_reference(model, cfg, [tok.encode(r["prompt"]) for r in recs],
                         [got[i][0]["tokens"] for i in range(len(recs))], label, max_seq_len=1024)
    print(f"{label} [{card}]: examples/batch-generation's params (int8, max_batch 16) at tensor=2, {len(recs)} "
          f"records of {GANG_BATCH_NEW} tokens: the follower SIGKILLed with {len(first)} durable, the leader out ({rc}) "
          f"{waited:.1f} s after; the rerun resumed {summary['resumed']} and wrote {summary['written']} in "
          f"{rerun_s:.1f} s ({summary['gen_tok_s']} tokens/s, occupancy {summary['slot_occupancy']}); every record "
          f"once, every token within the rule", flush=True)
    return {"reference": ref, "durable_at_kill": len(first), "kill_exit": rc, "kill_seconds": waited,
            "rerun": summary, "seconds": time.perf_counter() - t0}


def serve_gang_data_phase(card: str) -> dict:
    """(f)'s paged leg at data=2 x tensor=2, then the same with a
    self-draft (the target's checkpoint, int4 as the target), whose rounds
    exchange the draft's proposals [B, k] over the data group besides the
    verify's choices; apart from serve-gang to keep the default run inside
    its time."""
    import tempfile

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    _free_card()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gang_data_"))
    out = {}
    try:
        cfg = llama.CONFIGS["llama2-7b"].replace(n_layers=GANG_LAYERS)
        model = llama.init_params(cfg, seed=0, device="cuda")
        write_hf(str(tmp / "llama2-7b"), model)
        llama.quantize_weights(model, "int4")  # the bytes each rank quantizes whole, then slices
        tok = ByteTokenizer()
        ids = [tok.encode(text) for text, *_ in SPEC_PROMPTS]
        temps = [temp for _, _, temp, _ in SPEC_PROMPTS]
        plan = {"concurrent": True, "requests": [{"prompt": p, "max_tokens": GANG_SPEC_NEW, "temperature": t}
                                                 for p, t in zip(ids, temps)]}
        legs = [GANG_SPEC_PARAMS, {**GANG_SPEC_PARAMS, "draft_model": str(tmp / "llama2-7b")}]
        ranks = gang_worker_call(tmp / "llama2-7b", legs, plan, "serve-gang-data", "f4", world=4, timeout=420)
        greedy = [i for i, t in enumerate(temps) if t == 0.0]
        for leg, name in enumerate(("lookup", "self-draft")):
            label = f"serve-gang-data (f) data=2 x tensor=2, {name}"
            rows = spec_rows(ranks, leg, label)
            lead = ranks[0]["legs"][leg]
            st = lead["stats"]
            # a round exchanges the verify's choices; a draft round its proposals before them
            least = st["decode_steps"] + (st["verify_passes"] if leg else 0)
            if lead["mesh"]["data"] != 2 or [r["legs"][leg]["rows"] for r in ranks] != [[0, 12], [0, 12], [12, 24],
                                                                                         [12, 24]] or \
                    st["verify_passes"] <= 0 or len(lead["exchange_s"]) < least or (leg and st["spec_accepted"] <= 0):
                fail(f"{label}: mesh {lead['mesh']}, rows {[r['legs'][leg]['rows'] for r in ranks]}, stats {st}, "
                     f"{len(lead['exchange_s'])} exchanges (want {least} or more)")
            ref = gang_reference(model, cfg, [ids[i] for i in greedy], [rows[i] for i in greedy], label,
                                 max_seq_len=1024)
            exchange = statistics.median(lead["exchange_s"])
            round_ms = 1e3 * st["decode_seconds"] / st["decode_steps"]
            print(f"{label} [{card}]: four ranks' {sum(len(r) for r in rows)} tokens equal (the sampled rows too); "
                  f"{st['verify_passes']} verify passes of {st['decode_steps']} rounds, accepted "
                  f"{st['spec_accepted']}/{st['spec_proposed']}; the exchanges over the data group (gloo, int64: "
                  f"[24, w+1]{', and the proposals [24, 3]' if leg else ''}) median {1e3 * exchange:.3f} ms over "
                  f"{len(lead['exchange_s'])}; the round's host clock {round_ms:.2f} ms (four ranks time-slicing the "
                  f"card)", flush=True)
            out[name] = {"reference": ref, "stats": st, "round_ms": round_ms, "exchange_median_s": exchange,
                         "exchanges": len(lead["exchange_s"])}
        del model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_card()
    out["seconds"] = time.perf_counter() - t0
    print(f"serve-gang-data: {out['seconds']:.1f} s", flush=True)
    return out


def serve_gang_phase(card: str) -> dict:
    """A tensor-parallel gang of two ranks on the one card at llama2-7b's
    width and GANG_LAYERS layers: (a) serve.main x 2, bf16, dense, 8
    concurrent greedy requests held by the near-tie rule against a single
    process, then SIGTERM to the leader ends both ranks with 0; (b) two
    gang_worker ranks (a leg of gang_rest_legs' call), one sampled row,
    the ranks' tokens equal, and the
    numbers (the all-reduce, the broadcast, step and TTFT in turns with a
    single process, each rank's peak memory); (c) paged with int8 weights,
    4 requests sharing a prefix by the same rule, then a SIGKILLed follower
    fails the leader within its collective timeout; (f)-(h) speculation
    (the throughput example's params, paged and dense), a sharded
    self-draft and a tinyllama-width draft, and three tenants with a hot
    load, the first of each through serve.main over HTTP, the second in
    one gang_worker call (gang_rest_legs); (e) w8a8 on
    (c)'s int8 weights (gang_w8a8_leg); (i) serve.batchgen as a gang, a
    follower killed and a rerun (gang_batchgen_leg); (d) the llama2-70b
    example's gang of four ranks, data=2 x tensor=2 (gang_70b_leg)."""
    import tempfile

    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    label = "serve-gang"
    _free_card()
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gang_"))
    cfg = llama.CONFIGS["llama2-7b"].replace(n_layers=GANG_LAYERS)
    tok = ByteTokenizer()
    children = []
    try:
        model = llama.init_params(cfg, seed=0, device="cuda")
        model_dir = tmp / "llama2-7b"
        write_hf(str(model_dir), model)
        print(f"{label}: llama2-7b at {GANG_LAYERS} of its 32 layers (full width: dim 4096, 32 heads, hidden 11008, "
              f"vocab 32000), seed 0, written as an HF directory in {time.perf_counter() - t_phase:.1f} s; two ranks "
              "of tensor=2 on the one card (16 heads and 16 kv heads a rank)", flush=True)
        texts = [_long_text(n - 1, 110 + i) for i, n in enumerate(GANG_LENS)]
        prompts = [tok.encode(t) for t in texts]

        # (a) serve.main x 2, bf16, dense; 8 concurrent greedy requests.
        children, base, lead, follow = start_gang("a", {**GANG_PARAMS, "model": str(model_dir)})
        print(f"{label} (a): ranks ready in {children[0].ready_s:.1f} / {children[1].ready_s:.1f} s; leader: "
              f"{lead.split('; gang: ')[1].strip()}; follower: {follow.strip()}", flush=True)
        http(base, "/v1/completions", {"prompt": "warm up", "max_tokens": 2, "temperature": 0})
        time.sleep(0.5)
        counts0 = surface_launches(scrape(base))
        journeys, wall = run_traced(base, texts, 0x9a, GANG_NEW, f"{label} (a)")
        counts1 = surface_launches(scrape(base))
        served = [emitted(j["events"]) for j in journeys]
        reference = gang_reference(model, cfg, prompts, served, f"{label} (a)")
        delta = {k: counts1.get(k, 0) - counts0.get(k, 0) for k in counts1}
        launches = {"flash_fwd_tp2": delta.get("flash_attention.launches_wgmma", 0),
                    "flash_cached_tp2": delta.get("flash_cached_attention.launches_wgmma", 0),
                    "decode_attn_tp2": delta.get("decode_attention.launches_split", 0)}
        if min(launches.values()) <= 0 or any(v % GANG_LAYERS for v in launches.values()):
            fail(f"{label} (a): the leader's kernel launches {launches} ({delta})")
        exact = sum(r["argmax_agree"] for r in reference["requests"])
        total = sum(r["tokens"] for r in reference["requests"])
        print(f"{label} (a) [{card}]: {len(texts)} concurrent greedy requests of {min(GANG_LENS)}-{max(GANG_LENS)} "
              f"tokens, {GANG_NEW} new each, in {wall:.2f} s through the gang; {exact}/{total} served tokens the "
              f"single process's argmax, every one within the near-tie rule; the leader's launches {launches} "
              f"(per-rank heads: the flash forward's, cached flash's and decode kernel's designs)", flush=True)
        t_term = time.perf_counter()
        children[0].proc.send_signal(signal.SIGTERM)
        rcs = [c.proc.wait(timeout=120) for c in children]
        if rcs != [0, 0]:
            fail(f"{label} (a): after SIGTERM to the leader the ranks exited {rcs}")
        print(f"{label} (a): SIGTERM to the leader: it drained and broadcast stop; both ranks exited 0 in "
              f"{time.perf_counter() - t_term:.1f} s", flush=True)
        for c in children:
            c.stop()
        children = []

        # (b) the ranks agree; the numbers, in turns with a single process.
        single = Engine(cfg, model, EngineConfig(max_batch=8, max_seq_len=2048, kv_layout="dense"), device="cuda")
        single.start()
        try:
            engine_turn(single, prompts[:1])  # the graph's capture
            turn1 = engine_turn(single, prompts, GANG_SAMPLED)
            # (f)-(h) speculation, drafts and tenants: three serve.main gangs, and one gang_worker call with (b)'s
            # and (e)'s legs, on the bf16 weights.
            rest, (lead_r, follow_r), e_ranks = gang_rest_legs(card, tmp, model_dir, model, cfg, prompts)
            turn2 = engine_turn(single, prompts, GANG_SAMPLED)
        finally:
            single.stop()
        got = [q["tokens"] for q in lead_r["requests"]]
        if got != [q["tokens"] for q in follow_r["requests"]] or lead_r["error"] or follow_r["error"]:
            fail(f"{label} (b): the ranks' tokens differ or an engine failed: {lead_r['error']} {follow_r['error']}")
        greedy = [i for i in range(len(prompts)) if i != GANG_SAMPLED]
        ref_b = gang_reference(model, cfg, [prompts[i] for i in greedy], [got[i] for i in greedy], f"{label} (b)")
        bcast = sorted(s for _, s in lead_r["timings"])
        gang_ttft = [q["ttft_s"] for q in lead_r["requests"]]
        gang_step = 1e3 * lead_r["stats"]["decode_seconds"] / lead_r["stats"]["decode_steps"]
        ar = lead_r["allreduce_s"]
        print(f"{label} (b) [{card}]: both ranks' {sum(len(t) for t in got)} tokens equal, the sampled row "
              f"({len(got[GANG_SAMPLED])} tokens at temperature 0.8) too; data backend {lead_r['backend']} (two ranks "
              f"on one card), the event broadcast gloo", flush=True)
        print(f"{label} (b) [{card}]: gloo all-reduce of CUDA bf16 tensors, median of 50: [8,1,4096] "
              f"{1e3 * ar[f'8x1x{cfg.dim}']:.3f} ms, [1,512,4096] {1e3 * ar[f'1x512x{cfg.dim}']:.3f} ms; the event "
              f"broadcast "
              f"median {1e3 * statistics.median(bcast):.3f} ms over {len(bcast)} iterations (largest "
              f"{max(n for n, _ in lead_r['timings'])} bytes)", flush=True)
        print(f"{label} (b) [{card}]: in turns (single, gang, single; 8 requests at once, {GANG_NEW} new each): mean "
              f"decode step {turn1['step_ms']:.2f} / {gang_step:.2f} / {turn2['step_ms']:.2f} ms (the single process's "
              f"step one CUDA graph, the gang's eager); TTFT of the {GANG_LENS[-1]}-token prompt "
              f"{1e3 * turn1['ttft_s'][-1]:.1f} / {1e3 * gang_ttft[-1]:.1f} / {1e3 * turn2['ttft_s'][-1]:.1f} ms, mean "
              f"TTFT {1e3 * statistics.mean(turn1['ttft_s']):.1f} / {1e3 * statistics.mean(gang_ttft):.1f} / "
              f"{1e3 * statistics.mean(turn2['ttft_s']):.1f} ms; peak memory rank 0 {lead_r['peak_memory_bytes']} "
              f"bytes, rank 1 {follow_r['peak_memory_bytes']} bytes (the single process "
              f"{torch.cuda.max_memory_allocated()} bytes, this process)", flush=True)

        # (c) paged with int8 weights: 4 requests sharing a prefix; then the follower's SIGKILL.
        llama.quantize_weights(model, "int8")  # the ranks quantize the same layers whole, then slice
        c_texts = [GANG_PREFIX + _long_text(40 + 60 * i, 130 + i) for i in range(4)]
        c_prompts = [tok.encode(t) for t in c_texts]
        children, base, lead, _ = start_gang("c", {**GANG_C_PARAMS, "model": str(model_dir)})
        c_j, c_wall = run_traced(base, c_texts, 0x9c, 32, f"{label} (c)")
        c_served = [emitted(j["events"]) for j in c_j]
        ref_c = gang_reference(model, cfg, c_prompts, c_served, f"{label} (c)")
        hits = sum(e[2]["tokens"] for j in c_j for e in j["events"] if e[1] == "prefix_hit")
        timeout_s = int(lead.split("collective timeout ")[1].split()[0])
        t_kill = time.perf_counter()
        children[1].proc.kill()
        try:
            rc = children[0].proc.wait(timeout=timeout_s + 60)
        except subprocess.TimeoutExpired:
            fail(f"{label} (c): the leader still runs {timeout_s + 60} s after its follower's SIGKILL")
        waited = time.perf_counter() - t_kill
        if rc == 0 or waited > timeout_s:
            fail(f"{label} (c): after the follower's SIGKILL the leader exited {rc} in {waited:.1f} s "
                 f"(timeout {timeout_s} s)")
        print(f"{label} (c) [{card}]: paged, int8 weights: 4 requests sharing a {len(tok.encode(GANG_PREFIX))}-token "
              f"prefix ({hits} prompt tokens from the registry), 32 new each in {c_wall:.2f} s, every token within the "
              f"near-tie rule; the follower SIGKILLed: the leader exited {rc} after {waited:.1f} s (its collective "
              f"timeout {timeout_s} s)", flush=True)
        for c in children:
            c.stop()
        children = []

        # (e) w8a8 on (c)'s int8 weights; (i) batch generation (int8); (d) the llama2-70b example.
        leg_e = gang_w8a8_leg(card, e_ranks, model, cfg, prompts)
        leg_i = gang_batchgen_leg(card, tmp, model_dir, model, cfg)
        del model
        _free_card()
        leg_d = gang_70b_leg(card, tmp)
        launches.update(leg_d["launches"])
        launches.update(leg_e["launches"])
        launches.update(rest["launches"])
    finally:
        for c in children:
            c.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"{label}: {wall:.1f} s at {GANG_LAYERS} layers ((d) at {GANG_70B_LAYERS} of llama2-70b's)", flush=True)
    return {"layers": GANG_LAYERS, "launches": launches, "d": leg_d, "e": leg_e, "f_h": rest, "i": leg_i,
            "reference_a": reference, "reference_b": ref_b,
            "reference_c": ref_c, "allreduce_s": ar, "broadcast_median_s": statistics.median(bcast),
            "step_ms": {"single": [turn1["step_ms"], turn2["step_ms"]], "gang": gang_step},
            "ttft_s": {"single": [turn1["ttft_s"], turn2["ttft_s"]], "gang": gang_ttft},
            "peak_bytes": [lead_r["peak_memory_bytes"], follow_r["peak_memory_bytes"]],
            "worker_launches": lead_r["launches"], "kill_exit": rc, "kill_seconds": waited, "seconds": wall}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="card,build,kernels,serve,serve-long,serve-int4,serve-paged,serve-spec,"
                                        "serve-ckpt,serve-surface,train,train-full,serve-families,serve-batchgen,"
                                        "serve-adapters,serve-moe,serve-disagg,serve-w8a8,rl,serve-gang")
    phases = ap.parse_args().phases.split(",")
    t_start = time.perf_counter()
    phase_s = {}
    # Past WATCHDOG_S every thread's stack goes to standard error, so that a
    # run stopped at its time limit says where it was.
    faulthandler.dump_traceback_later(WATCHDOG_S)

    def timed(name, fn, *args, **kw):  # a phase's seconds, printed at the end
        t0 = time.perf_counter()
        print(f"chip_smoke: {name} from {t0 - t_start:.1f} s", file=sys.stderr, flush=True)
        try:
            out = fn(*args, **kw)
        except Exception as e:  # the traceback, then the phase's name last on both streams
            traceback.print_exc()
            fail(f"{name}: {type(e).__name__}: {e}")
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return out

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the card")
    try:
        from substratus_tpu_torch import kernels
    except ImportError as e:
        fail(f"the port is not importable here: {e}")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)
    report = {"card": card, "kind": kind}
    if "build" in phases:
        t0 = time.perf_counter()
        kernels.library()
        print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {kernels.build_seconds} s)", flush=True)
    if "kernels" in phases:
        report["kernels"] = timed("kernels", kernel_phase)
    if "serve" in phases:
        report["serve"] = timed("serve", serve_phase, card, profile_steps="profile" in phases)
    if "serve-long" in phases:
        report["serve-long"] = timed("serve-long", serve_long_phase, card, profile_steps="profile" in phases)
    if "serve-int4" in phases:
        report["serve-int4"] = timed("serve-int4", serve_int4_phase, card, profile_steps="profile" in phases)
    if "serve-paged" in phases:
        report["serve-paged"] = timed("serve-paged", serve_paged_phase, card, report.get("serve", {}).get("step_ms"),
                                      profile_steps="profile" in phases)
    if "serve-spec" in phases:
        report["serve-spec"] = timed("serve-spec", serve_spec_phase, card, profile_steps="profile" in phases)
    if "serve-ckpt" in phases:
        report["serve-ckpt"] = timed("serve-ckpt", serve_ckpt_phase, card)
    if "serve-surface" in phases:
        report["serve-surface"] = timed("serve-surface", serve_surface_phase, card)
    if "train" in phases:
        report["train"] = timed("train", train_phase, card, profile_steps="profile" in phases)
    if "train-full" in phases:
        report["train-full"] = timed("train-full", train_full_phase, card, profile_steps="profile" in phases)
    if "serve-families" in phases:
        report["serve-families"] = timed("serve-families", serve_families_phase, card)
    if "serve-batchgen" in phases:
        report["serve-batchgen"] = timed("serve-batchgen", serve_batchgen_phase, card)
    if "serve-adapters" in phases:
        report["serve-adapters"] = timed("serve-adapters", serve_adapters_phase, card)
    if "serve-moe" in phases:
        report["serve-moe"] = timed("serve-moe", serve_moe_phase, card, profile_steps="profile" in phases)
    if "serve-disagg" in phases:
        report["serve-disagg"] = timed("serve-disagg", serve_disagg_phase, card)
    if "serve-w8a8" in phases:
        report["serve-w8a8"] = timed("serve-w8a8", serve_w8a8_phase, card, profile_steps="profile" in phases)
    if "rl" in phases:
        report["rl"] = timed("rl", rl_phase, card, profile_steps="profile" in phases)
    if "serve-gang" in phases:
        report["serve-gang"] = timed("serve-gang", serve_gang_phase, card)
    if "serve-gang-data" in phases:
        report["serve-gang-data"] = timed("serve-gang-data", serve_gang_data_phase, card)
    report["wall_s"] = time.perf_counter() - t_start
    report["phase_s"] = phase_s
    faulthandler.cancel_dump_traceback_later()
    print(f"chip_smoke: phases {','.join(phases)} in {report['wall_s']:.1f} s; seconds by phase {phase_s}",
          flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    if "kernels" in phases:
        sources = {"flash_fwd": ("substratus_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                 "substratus_tpu/ops/flash_attention.py:91"),
                   "decode_attn": ("substratus_tpu_torch/csrc/decode_split.cu",
                                   "substratus_tpu/ops/decode_attention.py:138"),
                   "flash_cached": ("substratus_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                    "substratus_tpu/ops/flash_attention.py:452"),
                   "flash_cached_int8": ("substratus_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                         "substratus_tpu/ops/flash_attention.py:452"),
                   "fused_decode": ("substratus_tpu_torch/csrc/decode_split.cu",
                                    "substratus_tpu/ops/fused_decode.py:48"),
                   "q4_matmul_decode": ("substratus_tpu_torch/csrc/q4_matmul_decode.cu",
                                        "substratus_tpu/ops/quant4.py:168"),
                   "q4_matmul": ("substratus_tpu_torch/csrc/q4_matmul.cu", "substratus_tpu/ops/quant4.py:168"),
                   "q4_matmul_wgmma": ("substratus_tpu_torch/csrc/q4_matmul_wgmma.cu",
                                       "substratus_tpu/ops/quant4.py:168"),
                   "flash_bwd_dq": ("substratus_tpu_torch/csrc/flash_bwd_wgmma.cu",
                                    "substratus_tpu/ops/flash_attention.py:247"),
                   "flash_bwd_dkv": ("substratus_tpu_torch/csrc/flash_bwd_wgmma.cu",
                                     "substratus_tpu/ops/flash_attention.py:290"),
                   # the instances at head_dim 256
                   "flash_fwd_d256": ("substratus_tpu_torch/csrc/flash_fwd.cu",
                                      "substratus_tpu/ops/flash_attention.py:91"),
                   "flash_cached_d256": ("substratus_tpu_torch/csrc/flash_cached.cu",
                                         "substratus_tpu/ops/flash_attention.py:452"),
                   "flash_cached_int8_d256": ("substratus_tpu_torch/csrc/flash_cached.cu",
                                              "substratus_tpu/ops/flash_attention.py:452"),
                   "decode_attn_d256": ("substratus_tpu_torch/csrc/decode_attn.cu",
                                        "substratus_tpu/ops/decode_attention.py:138"),
                   "fused_decode_d256": ("substratus_tpu_torch/csrc/fused_decode.cu",
                                         "substratus_tpu/ops/fused_decode.py:48"),
                   "decode_split_d256": ("substratus_tpu_torch/csrc/decode_split.cu",
                                         "substratus_tpu/ops/decode_attention.py:138"),
                   "flash_bwd_dq_d256": ("substratus_tpu_torch/csrc/flash_bwd.cu",
                                         "substratus_tpu/ops/flash_attention.py:247"),
                   "flash_bwd_dkv_d256": ("substratus_tpu_torch/csrc/flash_bwd.cu",
                                          "substratus_tpu/ops/flash_attention.py:290"),
                   # w8a8: no TPU kernel; the XLA ops of qeinsum_w8a8 they replace
                   "w8a8_quantize": ("substratus_tpu_torch/csrc/w8a8_quantize.cu", "substratus_tpu/ops/quant.py:142"),
                   "w8a8_matmul": ("substratus_tpu_torch/csrc/w8a8_matmul.cu", "substratus_tpu/ops/quant.py:147"),
                   # serve-gang's per-rank shapes (tensor=2)
                   "flash_fwd_tp2": ("substratus_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                     "substratus_tpu/ops/flash_attention.py:91"),
                   "decode_attn_tp2": ("substratus_tpu_torch/csrc/decode_split.cu",
                                       "substratus_tpu/ops/decode_attention.py:138"),
                   "flash_cached_tp2": ("substratus_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                        "substratus_tpu/ops/flash_attention.py:452"),
                   # serve-gang (f)'s verify shapes a rank (tensor=2)
                   "flash_cached_int8_verify_tp2": ("substratus_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                                    "substratus_tpu/ops/flash_attention.py:452"),
                   "q4_matmul_wgmma_verify_tp2": ("substratus_tpu_torch/csrc/q4_matmul_wgmma.cu",
                                                  "substratus_tpu/ops/quant4.py:168"),
                   # serve-gang (d)'s per-rank int4 shapes (llama2-70b, tensor 2 and 8)
                   "q4_matmul_decode_70b": ("substratus_tpu_torch/csrc/q4_matmul_decode.cu",
                                            "substratus_tpu/ops/quant4.py:168"),
                   "q4_matmul_wgmma_70b": ("substratus_tpu_torch/csrc/q4_matmul_wgmma.cu",
                                           "substratus_tpu/ops/quant4.py:168"),
                   # (e)'s row-parallel w8a8 quantization: no TPU kernel (the XLA ops GSPMD partitions)
                   "w8a8_quantize_rows": ("substratus_tpu_torch/csrc/w8a8_quantize.cu",
                                          "substratus_tpu/ops/quant.py:142")}
        # Each kernel's launches come from the serve or train phase whose
        # path runs it (train: the first train.main call, 4 steps), as
        # (phase, its launch count): the flash forward's and the cached
        # flash's of their wgmma design, the cached flash's over the int8
        # cache apart, the decode kernels' of their split design, the int4
        # matmul's of each design (q4_matmul.cu's: none on the main path).
        phase_of = {"flash_fwd": ("serve", "flash_fwd_wgmma"), "decode_attn": ("serve", "decode_attn_split"),
                    "flash_cached": ("serve-long", "flash_cached_wgmma"),
                    "flash_cached_int8": ("serve-int4", "flash_cached_int8"),
                    "fused_decode": ("serve-long", "fused_decode_split"),
                    "q4_matmul_decode": ("serve-int4", "q4_matmul_decode"), "q4_matmul": ("serve-int4", "q4_matmul"),
                    "q4_matmul_wgmma": ("serve-int4", "q4_matmul_wgmma"),
                    "flash_bwd_dq": ("train", "flash_bwd_dq"), "flash_bwd_dkv": ("train", "flash_bwd_dkv"),
                    # serve-adapters (c): a model at gemma-7b's heads (head_dim 256) served and LoRA-trained;
                    # a group of 3 at 256 is no model's, so the split design's 4-warp instance runs on no path
                    **{name: ("serve-adapters", name) for name in (
                        "flash_fwd_d256", "flash_cached_d256", "flash_cached_int8_d256", "decode_attn_d256",
                        "fused_decode_d256", "decode_split_d256", "flash_bwd_dq_d256", "flash_bwd_dkv_d256")},
                    "w8a8_quantize": ("serve-w8a8", "w8a8_quantize"), "w8a8_matmul": ("serve-w8a8", "w8a8_matmul"),
                    # serve-gang (a): the leader's launches at the per-rank heads
                    **{name: ("serve-gang", name) for name in ("flash_fwd_tp2", "decode_attn_tp2",
                                                              "flash_cached_tp2", "q4_matmul_decode_70b",
                                                              "q4_matmul_wgmma_70b", "w8a8_quantize_rows",
                                                              "flash_cached_int8_verify_tp2",
                                                              "q4_matmul_wgmma_verify_tp2")}}
        # serve-spec's launches (legs (a) and (b)) of each design, and
        # serve-surface's (its child process's legs (a), (b) and (d)), each
        # its own count.
        spec_launches_of = report.get("serve-spec", {}).get("launches", {})
        surface_launches_of = report.get("serve-surface", {}).get("launches", {})
        # serve-families' (OPT and Falcon; falcon-7b's decode at G = 71).
        families_launches_of = report.get("serve-families", {}).get("launches", {})
        # serve-adapters (b)'s (int4 weights, the dense cache, the tenants' deltas on top).
        adapters_launches_of = report.get("serve-adapters", {}).get("launches_b", {})
        # serve-moe's (mixtral-8x7b: (a) int4 paged, (b) int8 dense, (c) the
        # 2-layer checkpoint at int4, (d) its LoRA steps), by design.
        moe_launches_of = report.get("serve-moe", {}).get("launches", {})
        # serve-disagg's (its four tiers, llama2-7b int4 on int8 and bf16 pages), by design.
        disagg_launches_of = report.get("serve-disagg", {}).get("launches", {})
        line = []
        for name, cases in report["kernels"].items():
            main_case = cases[0]  # the main path's shape
            line.append({
                "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
                "launches": report.get(phase_of[name][0], {}).get("launches", {}).get(phase_of[name][1], 0),
                "launches_serve_spec": spec_launches_of.get(phase_of[name][1]),
                "launches_serve_surface": surface_launches_of.get(phase_of[name][1]),
                "launches_serve_families": families_launches_of.get(phase_of[name][1]),
                "launches_serve_adapters": adapters_launches_of.get(phase_of[name][1]),
                "launches_serve_moe": moe_launches_of.get(phase_of[name][1]),
                "launches_serve_disagg": disagg_launches_of.get(phase_of[name][1]),
                "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
                "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
            })
        print(card, flush=True)
        print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
