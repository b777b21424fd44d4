#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, through the entry points a user
calls, and fails (exit code not 0, no result line) on any miss:

  1. gpu      the card's name and power limit, as nvidia-smi gives them;
  2. build    every CUDA kernel from ``csrc/``, one nvcc each, in parallel,
              with ptxas's registers and spills, the tensor-core flash
              kernel's shared memory, and the ring depth and shared memory
              of the WKV6 kernel and the RG-LRU scan's ring path;
  3. kernels  each kernel at the serving shapes against its plain PyTorch
              twin on the same inputs, with its stated tolerance, and its
              time beside the twin's, a library call's and its bound; the
              tensor-core flash kernel also beside the CUDA-core one on the
              same bf16 inputs, at recurrentgemma-9b's prefill and at
              whisper-medium's encoder, decoder and cross-attention (head_dim
              64); a bf16 case at head_dim 32 that stays on the CUDA-core
              kernel; the RG-LRU scan's path (TMA ring or simple)
              for each case, as the wrapper picks it, and the scan with a
              bf16 a and an fp32 b (the training backward's call) at the
              training shape, timed; the WKV6 decode step also as a CUDA
              graph of 20 steps (its device time without the wrapper's host
              time); flash at one rank's shapes of a tensor-parallel training
              step (internvl2-76b at 8 and 16 model ranks: 8/1 and 4/1 heads,
              D 128, B 1 x S 2560): the forward kernel, the backward it trains
              with (the plain fp32 recompute) checked against the plain
              twin's and timed, forward plus backward beside SDPA
              ``is_causal``'s, each with its bound;
  4. serve    ``repro_torch.launch.serve.main`` on recurrentgemma-9b at full
              width (38 layers, bf16, random seeded weights): 4 requests with
              prompts of 2304-2560 tokens, longer than the 2048 window, 16
              new tokens; the launch counts must show 12 tensor-core flash
              and 26 RG-LRU launches for its one prefill;
  5. check    recurrentgemma-9b at full width, depth cut to one pattern
              group, in fp32: prefill and decode logits on the card
              (kernels; fp32 attention runs the CUDA-core flash kernel)
              against the same weights on the CPU (plain path, which the CPU
              tests hold against the JAX reference);
  6. gemma2   gemma2-9b at full width, depth cut to 4 layers (2 local with
              softcap, 2 global), served through ServeEngine;
  7. rwkv6    ``launch.serve.main`` on rwkv6-7b at full width (32 layers,
              bf16), prompts of the same lengths as phase 4; the WKV kernel
              must run 32 times in the prefill and 32 times in each of the
              16 decode steps (544);
  8. check    rwkv6-7b at full width, depth cut to 2 layers, in fp32, card
              against CPU as in phase 5;
  8a. moe     qwen3-moe-235b-a22b at full width (128 experts top-8, QK-norm),
              depth cut to 8 layers (94 do not fit 80 GB), bf16, served
              through ServeEngine as phase 6: 4 requests of 2304-2560
              tokens, 16 new tokens, twice (cold, then warm); 8 tensor-core
              flash launches a prefill and none in decode; a third prefill
              split into the MoE stages (route, dispatch, expert products,
              combine) and flash under CUDA events;
  8a2. ep     expert parallelism on the ``model`` axis, right after 8a, in
              this one process: (b) phase 8a's weights sharded in place on a
              1-rank NCCL mesh, ``ShardedModel.prefill`` of its padded
              prompts and 16 ``decode_step`` calls fed 8a's greedy tokens
              (each MoE layer on the expert split's path, one block of all
              128 experts; decode attention over the cache's one sequence
              shard, which holds every position: the plain path, as one
              process's), against the same calls on
              the unsharded model, whose greedy choices must be 8a's: every
              call's logits within 5e-2 of the largest, the tokens that
              differ reported with their top-2 margin (a bf16 near-tie), 8
              tensor-core flash launches a prefill and none in decode,
              prefill and step ms beside 8a's; (a) each rank's share of one
              full-width MoE block computed in turn (``LayerAxis.moe`` over
              ``tensor_parallel.Shares``), the sums over ``model`` applied
              here: qwen3-moe-235b-a22b (128 experts top-8, ff 1536) at 8
              and 16 ranks, phi3.5-moe-42b-a6.6b (16 experts top-2, ff
              6400) at 16 (the expert split) and 32 (32 does not divide 16
              experts: the ff split, 200 columns a rank, forward only), B 1
              x S 2560; fp32: the output within 1e-4 of the unsplit block's
              largest, the input's and every leaf's gradient of <out, gy>
              and of the aux term within 2e-3 of its largest; bf16 within
              5e-2, each sum's terms added in fp32, the unsplit bf16
              block's own error against fp32 beside it; the slot rows a
              rank; (b) again under ``serve_2d``'s rules (on one rank no
              ``embed`` block stays: the same path), its tokens equal to
              ``fsdp_tp``'s, its decode ms a step beside them; (d) the same
              two MoE blocks under ``serve_2d`` on the (data 2 x model 8)
              and (data 4 x model 4) grids, every rank at once in threads
              (``tensor_parallel.ThreadRanks``), each computing with its
              (experts x embed block) of each expert leaf and its embed
              block of the router, the router's logits and the experts'
              pre-activations summed over ``data`` in the compute dtype,
              the output's block of columns gathered over it: a B 1 x S
              2560 prefill and a B 128 x 1 decode-shaped call, fp32 within
              1e-5 of the unsplit block's largest with its routing
              (choices, drops, slots) equal, bf16 within 5e-2 on the tokens
              routed as the unsplit bf16 block routes them, the flipped
              ones listed with their margins, the ranks bit-equal, no
              kernel launch, each call's ms; (c) phi3.5-moe-42b-a6.6b at
              full width, 1 layer, bf16 over fp32 masters, B 1 x S 2048, 3
              AdamW steps through ``train_loop`` unsharded, then the same
              weights and batches through ``ShardedModel`` on a 1-rank NCCL
              mesh: losses within 1e-5, 2 tensor-core flash launches a step,
              step ms and peak memory of both;
  8b. check   qwen3-moe-235b-a22b at full width, depth cut to 1 layer, fp32,
              card (the CUDA-core flash kernel) against CPU as in phase 5;
  8c. whisper whisper-medium at full width (24 + 24 layers, head_dim 64),
              bf16, through the model API: an encode of 4 x 1500 frames, cold
              and warm under CUDA events with each flash call's span, exactly
              24 tensor-core flash launches an encode, then 64 greedy decode
              steps from the start token with none; the CUDA-core kernel's
              time at the encoder shape (phase 3) times 24 against the encode;
  8d. check   whisper-medium cut to 2 + 2 layers, fp32: the encode's memory,
              the teacher-forced logits (448 tokens) and 8 decode steps, card
              (the CUDA-core flash kernel) against CPU, the same argmax;
  8e. vlm     internvl2-76b at full width (d 8192, 64/8 heads, head_dim 128,
              d_ff 28672, vocab 128256), depth cut to 24 of 80 layers (42.2
              GiB of bf16 weights; 80 do not fit 80 GB), through the model
              API with a seeded 256-row prefix (the stub frontend's image
              tile) before 2304-token prompts, B 4, a 4096-slot cache: a
              prefill cold and warm under CUDA events with flash's share,
              exactly 24 tensor-core flash launches a prefill, 16 greedy
              decode steps with none; tok/s and peak memory;
 8f. check    internvl2-76b in fp32, card (the CUDA-core flash kernel) against
              CPU: 2 layers, B 1, the prefix and 64 tokens, the prefill's and
              8 decode steps' logits and argmax; 1 layer (2.96B parameters),
              ``lm_loss`` with the prefix, the loss and every gradient;
 8g. tp_serve tensor-parallel serving on the ``model`` axis
              (``parallel/tensor_parallel.py``), all in this one process on
              the one card (two processes cannot share it: NCCL refuses two
              ranks on one device, and gloo's collectives on CUDA tensors
              crash): (c) phase 8e's weights sharded in place on a 1-rank
              NCCL mesh, ``ShardedModel.prefill`` and 16 greedy
              ``decode_step`` calls (every split whole, the cache's one
              sequence shard read on the plain path): 24 tensor-core flash
              launches a prefill, none in decode, tokens equal to phase
              8e's, prefill and step ms beside its; (a) each rank's share of a split computed in turn through
              the functions the ranks call (``tensor_parallel.share``), the
              sum over ``model`` applied here: one full-width internvl2-76b
              layer (64/8 heads, SwiGLU) at 8 and 16 ranks, one gemma2-9b
              layer (16/8 heads, head_dim 256, window 4096, softcaps) at 16,
              with each model's embedding and vocab head; B 1 x S 2560, fp32
              (1e-4 of the largest) and bf16 (5e-2), the unsplit bf16
              layer's own error against fp32 beside it. Phase 3 times flash
              at the per-rank shapes (8/1 and 4/1 heads at D 128, 1/1 at D
              256); (c) again under ``serve_2d``'s rules (a 1-rank mesh has
              no ``data`` block: the same path), tokens equal to 8e's, decode
              ms a step beside ``fsdp_tp``'s; (d) ``serve_2d``'s
              weight-stationary grid: the full-width internvl2-76b layer with
              its embedding and head on every rank of a (data 2 x model 8)
              and a (data 4 x model 4) grid at once, a thread a rank
              (``tensor_parallel.thread_shares``): each weight's (embed
              block x model block), the column products summed over
              ``data``, the row products' and the lookup's blocks gathered
              over it; B 1 x S 2560 and one decode step over the cache split
              by positions over (data, model), fp32 and bf16 with (a)'s
              tolerances, one tensor-core (or, in fp32, CUDA-core) flash
              launch a rank in the prefill and none in the step;
 8h. tp_train tensor-parallel training on the ``model`` axis, in this one
              process: (c) internvl2-76b at full width, 1 layer, bf16 over
              fp32 masters, remat "nothing", B 1 x (256 + 2048), 3 AdamW
              steps through ``train_loop`` unsharded, then the same seeded
              weights and batches through ``ShardedModel`` on a 1-rank NCCL
              mesh (the split path, every split whole), one after the other
              (about 47 GB each): losses within 1e-5, 2 tensor-core flash
              launches a step (the forward and the group's recompute), step
              ms of both; (a) each rank's training share of one full-width
              internvl2-76b layer at 8 and 16 ranks and a gemma2-9b layer at
              16 (its 8 KV heads read in part), each with its embedding, head
              and vocab-parallel cross-entropy, B 1 x S 2560, the sums over
              ``model`` applied here and one backward: the loss and the
              layer's output within 1e-4 of the unsplit layer's largest and
              each gradient within 2e-3 of its leaf's largest in fp32, 5e-2
              in bf16 with the unsplit bf16 layer's own error beside it;
 8h2. sp_train sequence parallelism in sharded training, in this one
              process: (a) each rank's share in the sequence form
              (``tensor_parallel.seq_shares``: each rank normalizes its
              2560/W positions, the gathers and reduce-scatters of the
              stream played there): one full-width internvl2-76b layer at 8
              and 16 ranks, one recurrentgemma-9b RG-LRU layer (the scan on
              the gathered sequence) at 16, one qwen3-moe MoE half-block at
              16, B 1 x S 2560, one backward: the output blocks concatenated
              within 1e-4 of the unsplit layer's largest and each gradient
              (the norm scales' summed, the RG-LRU's its rank's channels)
              within 2e-3 of its leaf's largest in fp32, 5e-2 in bf16
              (terms added in fp32) with the unsplit bf16 layer's own error
              beside it; flash (one a rank) and scan (two a rank) launches
              counted; (b) phase 8h's 1-rank path under ``fsdp_tp`` splits
              no sequence, its losses bit-equal to ``train_loop``'s;
 8h3. rnn_split the RG-LRU split along its recurrent channels on the model
              axis, in this one process: (a) each rank's share of
              recurrentgemma-9b's layer 0 at full width (norm1, the RG-LRU,
              the residual) at 8 and 16 ranks (512 and 256 channels, 2 and 1
              gate blocks a rank), B 1 x S 2560, in the plain form (every
              rank on the whole normed stream) and the sequence form
              (``tensor_parallel.seq_shares``), the terms added in fp32, one
              backward: the output within 1e-4 of the unsplit half's largest
              and every gradient (the gates' from their blocks) within 2e-3
              of its leaf's largest in fp32, 5e-2 in bf16 with the unsplit
              bf16 half's own error beside it, two scan launches a rank
              (forward and backward) on its channels; (b) recurrentgemma-9b
              at one (rglru, rglru, attn_local) group on a 1-rank NCCL mesh
              (one block of all 4096 channels): a bf16 prefill of B 2 x S
              2560 and 16 decode steps unsharded and through
              ``ShardedModel`` fed the same tokens, each call's greedy token
              equal (a flip only at a near-tie, reported with its margin),
              2 scan launches and 1 flash a prefill, none a step; 2 AdamW
              steps (bf16 over fp32 masters, B 1 x S 2048) through
              ``train_loop`` unsharded and sharded, the losses bit-equal, 6
              scan and 2 flash launches a step; prefill, step and training
              ms of each side, and the serving again under ``serve_2d`` on
              the one rank, its tokens equal to ``fsdp_tp``'s; (c) the full-
              width layer 0 (norm1, the RG-LRU, norm2, the MLP) under
              ``serve_2d`` on (data 2 x model 8), (data 4 x model 4) and
              (data 4 x model 8), every rank a thread serving the RG-LRU on
              its (data, model) chunk of the channels as they lie at rest
              (256 channels, a gate block; 128, half a block): a B 1 x S 2560
              prefill and 4 decode steps, and a 128-row step from a seeded
              state, fp32 and bf16, every rank's stream within 1e-4 (fp32)
              and 5e-2 (bf16) of the unsplit layer, its h and conv chunk
              against the unsplit state's, ranks bit-equal, one scan launch
              a rank a prefill. The kernels phase times the scan at one
              rank's widths: [1, 2560, 256] and [1, 2560, 512] bf16, the
              backward's bf16 a with fp32 b at [1, 2560, 256], the serving
              [4, 2560, 256], and serve_2d's chunks [1, 2560, 256], [1,
              2560, 128] and [1, 2560, 16] (a rank of 16 x 16);
 8h4. rwkv_split the RWKV-6 split on the model axis in serving and in
              training, in this one process: (a) each rank's share of
              rwkv6-7b's layer 0 at full
              width (norm1, the time mix, norm2, the channel mix, both
              residuals) at 8 and 16 ranks (8 and 4 of the 64 heads, 1792 and
              896 of the 14336 ``d_ff`` columns), a B 1 x S 2560 prefill and
              4 decode steps from the carried state
              (``tensor_parallel.rwkv_shares``: the time mix's terms and the
              channel mix's value terms added in fp32, each rank's block of
              the channel mix laid side by side), against the unsplit layer:
              fp32 within 1e-4 of the largest, bf16 within 5e-2 beside the
              unsplit bf16 layer's own error against fp32, each rank's WKV
              state block against that block of the unsplit state, one wkv6
              launch a rank a call on its heads; (b) rwkv6-7b at full width
              cut to 4 layers on a 1-rank NCCL mesh under ``fsdp_tp`` (one
              block of all 64 heads, the WKV state where it lies): a bf16
              prefill of B 4 x S 2560 and 16 decode steps unsharded and
              through ``ShardedModel`` fed the same tokens, each call's
              greedy token equal (a flip only at a near-tie, reported with
              its margin), logits within 5e-2, whether the prefill's are
              bit-equal, prefill and step ms of each side, 4 wkv6 launches a
              prefill and 4 a step; then the same under ``serve_2d`` (one
              ``data`` rank: no ``embed`` block stays), its tokens equal to
              ``fsdp_tp``'s; (c) the layer's training shares at 8
              and 16 ranks, B 1 x S 256 (the WKV twin trains a Python loop
              a step), one backward: the plain form
              (``tensor_parallel.rwkv_shares`` without caches) and the
              sequence form (``tensor_parallel.seq_shares``), fp32 outputs
              within 1e-4 and every gradient within 2e-3 of its leaf's
              largest, bf16 within 5e-2 beside the unsplit bf16 layer's own
              error, no wkv6 launch; (d) rwkv6-7b at full width cut to 2
              layers, 2 AdamW steps (bf16 over fp32 masters, remat
              "nothing", B 2 x S 512) through ``train_loop`` unsharded and
              on a 1-rank NCCL mesh under ``fsdp_tp``, the losses
              bit-equal, step ms of both, no wkv6 launch; (e) the layer
              under ``serve_2d`` on (data 2 x model 8) and (data 4 x model
              4), every rank a thread (``tensor_parallel.thread_shares``),
              each computing with its (embed block x model block) of the
              mixers' weights (``tm.w_v`` on its rows, ``decay_b`` gathered
              over ``data``): a B 1 x S 2560 prefill and 4 decode steps,
              and one decode step of decode_32k's 128 rows from a seeded
              carried state, fp32 within 1e-4 and bf16 within 5e-2 (the
              partial products added in bf16) beside the unsplit bf16
              layer's own error, each rank's WKV block and shifts against
              the unsplit state, the ranks bit-equal, one wkv6 launch a
              rank a call (``rwkv_grid_shares`` lines). The kernels phase
              times wkv6 at one rank's heads: B 1 x T 2560 at 4, 8 and 16
              heads, a B 4 decode step at 4, and a B 128 decode step at 8
              and 16 (a rank of the two grids);
 9. train    ``train_loop`` on recurrentgemma-9b at full width, depth cut
              to one (rglru, rglru, attn_local) group: bf16 compute over fp32
              masters, remat "nothing", B 2 x S 2560 from ``SyntheticLM``, 4
              steps and one more with grad_accum=2; exactly 2 tensor-core
              flash and 6 RG-LRU launches a step (twice that with
              grad_accum=2); prints the step time (CUDA events, median after
              the first), tokens/s, peak memory and model FLOPs against the
              card's dense bf16 peak;
 10. check    the loss and every parameter's gradient in fp32 on the card
              against the CPU: recurrentgemma-9b (3 layers, B 1 x S 2176,
              the CUDA-core flash kernel and the scan) and rwkv6-7b (2
              layers, B 1 x T 256, the chunked WKV twin: no wkv6 launch) and
              phi3.5-moe-42b-a6.6b (1 layer, 16 experts top-2, layernorm, B 1
              x S 1024, remat "nothing": flash in the forward and again in the
              recompute; the routers' gradients and the aux loss compared);
 10a. whisper whisper-medium cut to 2 + 2 layers, fp32, B 1 x 1500 frames x 448
              tokens, remat "nothing": the loss and every gradient, card
              against CPU (the key biases' gradients, 0 exactly, held to
              their layer's wk gradient); then at full width, B 4, bf16 over
              fp32 masters, one cold and one timed AdamW step with 144
              tensor-core flash launches (72 forward, 72 in the recompute);
 10b. whisper_tp_train sharded whisper-medium training on the ``model``
              axis, in this one process: (a) each rank's training share of
              one full-width encoder block (B 1 x 1500 frames) and one
              decoder block (B 1 x 448 tokens over a 1500-frame memory) at 4
              and 16 ranks (4 heads and 1 head of 16, d_ff blocks of 1024
              and 256; ``tensor_parallel.block_shares``: each part's normed
              input and the memory fed to every rank, the split parts'
              terms added in fp32), one backward from one upstream
              gradient: the output, the input's and the memory's gradients
              and every leaf's against the unsplit block's, fp32 (the
              CUDA-core flash kernel) within 1e-5 of each largest, bf16 (the
              tensor-core kernel) within 5e-2 beside the unsplit bf16 block's
              own error; W flash launches an encoder block and 2W a decoder
              block; (b) whisper-medium at 1 + 1 layers, B 4 x 1500 frames x
              448 tokens, bf16 over fp32 masters: 3 steps of
              ``launch/steps.build_train_step`` on a 1-rank NCCL mesh (the
              sharded step) against ``train_loop`` unsharded from the same
              seeded weights and batch, losses within 1e-6 (bit-equality
              printed), step ms of both under CUDA events, 6 tensor-core
              flash launches a step (a 1-rank axis splits no stream); (c)
              the sequence form of (a) (``share(..., seq_len=)`` with both
              streams' lengths: each rank normalizes its own positions, the
              normed blocks concatenated are every rank's gathered input,
              the summed terms sliced to each rank's positions, the memory
              whole) at 4 ranks over 1500 frames (both streams split), 16
              over 1500 (the encoder's 1500 frames do not split: it runs
              whole; the decoder's 448 tokens do) and 16 over 4096 (both),
              the same tolerances and launches (``whisper_tp_seq_shares``
              lines);
 10c. whisper_tp_serve sharded whisper-medium serving on the ``model``
              axis, in this one process: (a) each rank's share of one
              full-width decoder block's decode at 4 and 16 ranks (4 heads
              and 1 head of 16, d_ff blocks of 1024 and 256;
              ``tensor_parallel.share`` on the card: the rank's heads' block
              of a 448-slot self cache, its cross-attention heads over a
              1500-frame memory), B 4, 16 steps from an empty cache
              (``block_shares(..., pos=t)``, the split parts' terms added in
              fp32): every step's output and each rank's cache block against
              the unsplit ``DecBlock.decode``'s, fp32 within 1e-5 of the
              largest, bf16 within 5e-2 beside the unsplit bf16 block's own
              error, no kernel launch (decode is the plain path); then,
              all ranks at once in threads over a self cache split by
              positions, and at 4 ranks with the 1500-frame memory split
              along ``model`` (``Shard(1)``, as the sharded encode returns
              it) and gathered once a step (``ModelAxis.memory_in``,
              counted), ranks bit-equal, the same tolerances; then the
              encode's block in the sequence form, forward only: one
              full-width encoder block, B 4, at 4 ranks over 1500 frames,
              16 over 1500 (the stream whole) and 16 over 4096, each rank
              on its own positions with the gathers and reduce-scatters
              played, fp32 1e-5 and bf16 5e-2, W flash launches; (b)
              whisper-medium at full width (24 + 24 layers, bf16), B 4 x 1500
              frames: the encode and 65 decode calls (the start token, then
              64 greedy) unsharded, then the same weights on a 1-rank NCCL
              mesh through ``ShardedModel.prefill`` and ``decode_step`` fed
              the unsharded tokens: the memory and every call's logits
              within 1e-3 of the largest (bit-equality printed), greedy
              tokens equal (a flip reported with its top-2 margin), 24
              tensor-core flash launches an encode and none a decode step
              on both sides, encode ms and decode ms a step (wall and CUDA
              events) of both; then the same mesh under ``serve_2d``: the
              encode and 17 greedy decode calls, tokens equal to the
              ``fsdp_tp`` path's; (d) ``serve_2d``'s weight-stationary
              whisper on (data 2 x model 8) and (data 4 x model 4) in
              threads (``thread_shares`` on the whole model): one
              full-width encoder block and one decoder block with the
              embedding and the tied head, fp32 then bf16, each rank from
              its (embed block x model block) of each weight but the
              cross-attention's ``wk`` and ``wv``: an encode of B 1 x 1500
              frames, then 4 decode steps over its block of a seeded
              448-slot self cache; every rank's memory, streams, logits and
              cache block against the unsplit model's (fp32 1e-4, bf16
              5e-2), ranks bit-equal, one flash launch a rank an encode and
              none in decode (``whisper_serve_grid_shares`` lines, with the
              seconds of each grid). The kernels phase times flash at one rank's
              encode shape: B 4 x 1500 frames, 4/4 and 1/1 heads, D 64, bf16;
 11. train_lm ``repro_torch.launch.train_lm --steps 60`` (nemo-100m, fp32):
              finite losses, the last logged below the first.
 12. dispatch the BandPilot dispatcher (``repro_torch.core``) on the paper's
              32-GPU H100 and Het-4Mix clusters: the surrogate trained on the
              card (the quickstart's 250 samples, 2000 steps; its first 50
              steps' losses against the CPU's from the same init and
              batches), scored on the card against the CPU on 4096 random
              subsets a cluster (isolated and contended applies), the
              Fig. 1 scenario and the quickstart's dispatcher comparison,
              the fused descent (each a CUDA graph replay: capture seconds a
              bucket, per-descent time, every round audited against the
              host loop), and traces through ``AdmissionScheduler`` (the
              pinned 14-job fifo golden and a 200-job Poisson trace,
              analytic mode on both clusters, learned mode on H100) whose
              subsets must equal the CPU's; no port kernel runs on it;
 13. elastic  BandPilot-placed training (``launch/elastic.py``,
              ``parallel/fsdp.py``) on recurrentgemma-9b at full width, depth
              cut to one (rglru, rglru, attn_local) group, bf16 over fp32
              masters, B 1 x S 2048, 5 steps: (a) ``train_loop`` uninterrupted;
              (b) the sharded step on a 1-rank NCCL mesh over the card, 16 of
              the simulated 32-GPU H100 cluster dispatched, a checkpoint (about
              19.7 GB: parameters and both moments in fp32, free space checked
              first) and host 1's failure at step 3, re-dispatch, a new mesh,
              restore, resume; (c) the same coordinator on the CPU. (b)'s
              losses within 1e-5 of (a)'s (bit-equality printed), its event log
              (allocations, predicted GB/s) equal to (c)'s, no GPU of the dead
              host re-used, 2 tensor-core flash and 6 RG-LRU launches a step;
              step ms under CUDA events, checkpoint bytes, save and restore s,
              and the time to recover split into re-dispatch, mesh build,
              restore and the first resumed step. Then
              ``repro_torch.launch.train`` on the same config for 2 steps.
 14. dryrun   the dry run (``launch/dryrun.py``) held against the card on a
              1-rank NCCL mesh: internvl2-76b's train step (``launch/steps.py``;
              1 layer, B 1 x (256 + 2048), bf16 over fp32 masters) and the
              prefill of phase 8e, each traced on meta tensors and run: the
              predicted FLOPs must equal ``FlopCounterMode``'s on the card and
              the predicted peak memory be within 15% of
              ``max_memory_allocated``; the roofline's three terms beside the
              step's ms. Then ``python -m repro_torch.launch.dryrun`` on
              internvl2-76b x {train_4k, prefill_32k, decode_32k} and
              recurrentgemma-9b x long_500k (the 16 x 16 mesh of fake ranks),
              its table printed.
 15. perf_check  the perf experiments (``launch/perf.py``): (a) phase
              14's internvl2-76b train step on the 1-rank NCCL mesh, traced
              and run as ``baseline`` and again under ``cast_barrier``
              (``REPRO_CAST_BARRIER=1`` for that call only): the losses of its
              two steps bit-equal (a gather over one rank copies nothing),
              FLOPs and peak as phase 14 holds them, 2 tensor-core flash
              launches a step; (b) ``python -m repro_torch.launch.perf`` on
              internvl2-76b x train_4k, one subprocess an experiment, started
              before (a) and run beside it: each of ``baseline``,
              ``cast_barrier``, ``rs_grads``, ``chunked_attn``, ``bf16_wire``,
              ``grad_bf16`` and ``no_seq_shard`` exits 0 and prints its row;
              ``cast_barrier``'s weight gathers over ``data`` are half of
              ``baseline``'s, ``rs_grads`` and ``chunked_attn`` equal
              ``baseline`` but for the seconds; ``moe_ep2d`` alone exits 1 with
              its reason.

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""

import copy
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import surrogate as surr  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import KERNELS, cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_ops, ref as lru_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops, ref as wkv_ref  # noqa: E402
from repro_torch.ft.elastic import ElasticCoordinator, FailureEvent  # noqa: E402
from repro_torch.ft.elastic import run_elastic_training  # noqa: E402
from repro_torch.launch import elastic as launch_elastic  # noqa: E402
from repro_torch.launch import serve as launch_serve, train_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch import dryrun, perf, roofline, shapes, steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh_from_devices, process_group  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.moe import MoE, bf16_gates  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import LM, lm_loss  # noqa: E402
from repro_torch.parallel import sharding as shd, tensor_parallel as tp  # noqa: E402
from repro_torch.parallel.fsdp import ShardedModel  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_loop import TrainRunConfig, make_train_step, train_loop  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense), in ``launch/roofline.py``:
# HBM bytes/s (``HBM_BW``) and operations/s by input type (``PEAK_OPS_PER_S``:
# bf16 on the tensor cores, fp32 on the CUDA cores).

SEED = 0
SERVE_FLAGS = ["--batch", "4", "--prompt-len", "2560", "--min-prompt-len", "2304",
               "--max-len", "4096", "--max-new", "16", "--seed", str(SEED)]


def need(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters, warmup=1):
    """Mean device milliseconds of fn() over iters back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, steps=20, replays=10):
    """Device ms per call of fn, as the replay of a CUDA graph of ``steps``
    calls (the host's launch time left out)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(steps):
            fn()
    return cuda_ms(graph.replay, iters=replays) / steps


def bound(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / roofline.HBM_BW * 1e3
    t_ops = n_ops / roofline.PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain twin
# ---------------------------------------------------------------------------

def flash_case(name, B, S, Hq, Hkv, D, window, softcap, dtype, tol, timed,
               previous=False, causal=True, S_k=None, graph=False):
    """Through ``fa_ops.attention``, which picks the kernel for dtype and
    head_dim; S queries against ``S_k`` keys (default S). tol bounds
    |kernel - plain| by tol * (1 + |plain|): in bf16 one ulp of the output
    (the tensor-core kernel also rounds P to bf16 before P V, a relative
    error of at most 2^-9 on each weight of an average), in fp32 the
    summation order. ``previous``: the CUDA-core kernel on the same inputs
    too, checked and, if ``timed``, timed in turns with the new one.
    ``graph``: also the call's device time as a CUDA graph's replay (a call
    of tens of microseconds is otherwise timed at the wrapper's host time)."""
    dev = torch.device("cuda")
    S_k = S if S_k is None else S_k
    g = torch.Generator(device=dev).manual_seed(S + Hkv)
    q = torch.randn(B, S, Hq, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S_k, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S_k, Hkv, D, generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    kernel = fa_ops.kernel_for(dtype, D)
    out = fa_ops.attention(q, k, v, **kw)
    want = fa_ref.attention_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()

    def check(out, what):
        need(torch.isfinite(out.float()).all(), f"flash {name} ({what}): non-finite output")
        diff = (out.float() - want).abs()
        err = float(diff.max())
        need(bool((diff <= tol * (1 + want.abs())).all()),
             f"flash {name} ({what}): error above {tol} * (1 + |plain|), max abs {err}")
        return err

    rec = {"case": name, "kernel": kernel, "shape": [B, S, Hq, Hkv, D], "S_k": S_k,
           "causal": causal, "dtype": str(dtype)[6:], "window": window, "softcap": softcap,
           "max_abs_err": check(out, kernel), "tol": f"{tol} * (1 + |plain|)"}
    del out
    if previous:
        rec["previous_max_abs_err"] = check(fa_ops.flash_attention_cuda(q, k, v, **kw),
                                            "simt")
    print("kernel_check flash_attention", json.dumps(rec), flush=True)
    if not timed:
        return rec
    run = lambda: fa_ops.attention(q, k, v, **kw)  # noqa: E731
    lib = None
    if softcap is None:  # one library call computes the same function
        # its fastest form: no mask where every key is seen, is_causal where
        # the mask is exactly causal, else the mask itself
        if window is None and not causal:
            rec["library_call"], lib_kw = "no mask", {}
        elif window is None and S == S_k:
            rec["library_call"], lib_kw = "is_causal", {"is_causal": True}
        else:
            rec["library_call"] = "mask"
            lib_kw = {"attn_mask": fa_ref.attention_mask(S, S_k, causal, window, 0, dev)}
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, enable_gqa=Hq != Hkv, **lib_kw)
        # a yardstick only: it must compute the same function (a wrong mask
        # would be off by O(1)), in its own rounding
        rec["library_max_abs_err"] = float((lib().transpose(1, 2).float() - want).abs().max())
        need(rec["library_max_abs_err"] < 0.1, f"flash {name}: library call disagrees")
    del want
    # in turns on one card: kernel, previous kernel, library, kernel
    runs = [cuda_ms(run, iters=20)]
    if previous:
        rec["previous_ms"] = cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **kw),
                                     iters=3)
    rec["library_ms"] = cuda_ms(lib, iters=5) if lib else None
    runs.append(cuda_ms(run, iters=20))
    rec["ms_runs"], rec["ms"] = runs, sum(runs) / len(runs)
    if graph:
        rec["graph_ms"] = graph_ms(run)
        rec["library_graph_ms"] = graph_ms(lib) if lib else None
    rec["plain_ms"] = cuda_ms(lambda: fa_ref.attention_plain(q, k, v, **kw), iters=3)
    ops = 4 * D * fa_ops.visible_pairs(S, S_k, causal, window) * B * Hq
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(q, k, v, q), ops, dtype)
    rec["tflop_per_s"] = ops / (rec["ms"] * 1e-3) / 1e12
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    print("kernel_time flash_attention", json.dumps(rec), flush=True)
    return rec


def rglru_case(name, B, T, C, with_h0, dtype, timed, dtype_b=None):
    """``dtype_b``: b's dtype when it is not a's (the training backward's
    bf16 a with fp32 b); h and h0 are in a's dtype."""
    dev = torch.device("cuda")
    dtype_b = dtype if dtype_b is None else dtype_b
    g = torch.Generator(device=dev).manual_seed(T + C)
    a = (0.7 + 0.299 * torch.rand(B, T, C, generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn(B, T, C, generator=g, device=dev)).to(dtype_b)
    h0 = (0.1 * torch.randn(B, C, generator=g, device=dev)).to(dtype) if with_h0 else None
    h, h_final = lru_ops.linear_scan(a, b, h0)
    want, want_final = lru_ref.linear_scan_reference(a, b, h0)
    torch.cuda.synchronize()
    # same roundings as the plain loop (separate multiply and add): exact
    err = max(float((h.float() - want.float()).abs().max()),
              float((h_final.float() - want_final.to(dtype).float()).abs().max()))
    rec = {"case": name, "shape": [B, T, C], "dtype": str(dtype)[6:],
           "dtype_b": str(dtype_b)[6:], "h0": with_h0,
           "route": lru_ops.route_for(dtype, C, dtype_b), "max_abs_err": err, "tol": 0.0}
    print("kernel_check rglru_scan", json.dumps(rec), flush=True)
    need(err == 0.0, f"rglru {name}: max abs err {err} != 0")
    if not timed:
        return rec
    rec["ms"] = cuda_ms(lambda: lru_ops.linear_scan(a, b, h0), iters=20)
    rec["plain_ms"] = cuda_ms(lambda: lru_ref.linear_scan_reference(a, b, h0), iters=2)
    rec["library_ms"] = None  # no single PyTorch call computes a linear recurrence
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(a, b, h0, h, h_final), 2 * B * T * C,
                                             torch.float32)
    print("kernel_time rglru_scan", json.dumps(rec), flush=True)
    return rec


def wkv6_case(name, B, T, H, with_s0, dtype, timed):
    """s_final has tolerance 0: the state update rounds as the plain loop does
    (separate fp32 multiply and add). y bounds |kernel - plain| by
    tol * (1 + |plain|): in fp32 (1e-5) the K-sum's order, in bf16 (2e-2) one
    ulp of the output (both sides round nearly the same fp32 value)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(T + H)
    r, k, v = (0.5 * torch.randn(B, T, H, 64, generator=g, device=dev).to(dtype)
               for _ in range(3))
    # the time mix's decays: exp(-exp(x)) for x in the decay_base range
    w = torch.exp(-torch.exp(-6.0 + 5.5 * torch.rand(B, T, H, 64, generator=g,
                                                     device=dev))).to(dtype)
    u = (0.5 * torch.randn(H, 64, generator=g, device=dev)).to(dtype)
    s0 = torch.randn(B, H, 64, 64, generator=g, device=dev) if with_s0 else None
    y, s_final = wkv_ops.wkv(r, k, v, w, u, s0)
    want, want_final = wkv_ref.wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    need(torch.isfinite(y.float()).all(), f"wkv6 {name}: non-finite output")
    diff = (y.float() - want.float()).abs()
    err = float(diff.max())
    state_err = float((s_final - want_final).abs().max())
    rec = {"case": name, "shape": [B, T, H, 64, 64], "dtype": str(dtype)[6:],
           "s0": with_s0, "max_abs_err": err, "tol": f"{tol} * (1 + |plain|)",
           "state_max_abs_err": state_err, "state_tol": 0.0}
    print("kernel_check wkv6", json.dumps(rec), flush=True)
    need(bool((diff <= tol * (1 + want.float().abs())).all()),
         f"wkv6 {name}: y error above {tol} * (1 + |plain|), max abs {err}")
    need(state_err == 0.0, f"wkv6 {name}: s_final max abs err {state_err} != 0")
    if not timed:
        return rec
    rec["ms"] = cuda_ms(lambda: wkv_ops.wkv(r, k, v, w, u, s0), iters=20)
    if with_s0:  # a decode step: also its device time, the cache updated in place
        state = s0.clone()
        rec["graph_ms"] = graph_ms(lambda: wkv_ops.wkv(r, k, v, w, u, state, out=state))
    rec["plain_ms"] = cuda_ms(lambda: wkv_ref.wkv6_reference(r, k, v, w, u, s0), iters=2)
    rec["library_ms"] = None  # no single PyTorch call computes this recurrence
    # 5 fp32 operations per state element per step on the CUDA cores: r*S into
    # y (a multiply-add, 2) and w*S + k*v (3); the bonus term is v * sum_k(r u k),
    # O(K + V) per step, nothing per state element
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(r, k, v, w, u, s0, y, s_final),
                                             5 * B * T * H * 64 * 64, torch.float32)
    # an exact state update issues 4 fp32 instructions per element per step
    # (y's multiply-add; w*S, k*v and their sum); the fp32 rate counts a
    # multiply-add as 2 operations, so lanes issue at half of it. A derived
    # floor, printed here and kept out of the kernel's record.
    floor_ms = 4 * B * T * H * 64 * 64 / (roofline.PEAK_OPS_PER_S[torch.float32] / 2) * 1e3
    print("kernel_time wkv6", json.dumps({**rec, "instruction_floor_ms": floor_ms}), flush=True)
    return rec


TP_FLASH_CASES = ("internvl2-76b at 8 model ranks", "internvl2-76b at 16 model ranks",
                  "gemma2-9b at 16 model ranks")


def tp_flash_cases():
    """Flash at the shapes one rank of a tensor-parallel prefill gives it:
    its query heads and the KV heads they read (``tensor_parallel``)."""
    S = VLM_P + VLM_S
    return [flash_case(TP_FLASH_CASES[0], VLM_B, S, 8, 1, 128, None, None, torch.bfloat16,
                       2e-2, timed=True, graph=True),
            flash_case(TP_FLASH_CASES[1], VLM_B, S, 4, 1, 128, None, None, torch.bfloat16,
                       2e-2, timed=True, graph=True),
            flash_case(TP_FLASH_CASES[2], VLM_B, S, 1, 1, 256, 4096, 50.0, torch.bfloat16,
                       2e-2, timed=True, graph=True)]


TP_TRAIN_FLASH_CASES = ("internvl2-76b training at 8 model ranks",
                        "internvl2-76b training at 16 model ranks")
TP_TRAIN_FLASH_KEYS = ("case", "shape", "ms", "graph_ms", "plain_ms", "library_ms",
                       "library_graph_ms", "bound_ms", "bound_by", "max_abs_err", "bwd_ms",
                       "bwd_rel_err", "bwd_bound_ms", "bwd_bound_by", "fwd_bwd_ms",
                       "library_fwd_bwd_ms", "fwd_bwd_bound_ms", "fwd_bwd_bound_by",
                       "train_ms_runs")


def flash_train_case(name, B, S, Hq, Hkv, D):
    """One rank's flash call in a tensor-parallel training step (causal, bf16):
    ``flash_case``'s forward (the kernel against its plain twin, timed beside
    SDPA ``is_causal``), then the backward the port trains with
    (``ops._FlashAttention``: the plain fp32 recompute and its VJP) checked
    against the plain twin's VJP and timed, and forward plus backward beside
    SDPA's, each with its bound (the backward's 5 products to the forward's
    2: 2.5 times its operations)."""
    rec = flash_case(name, B, S, Hq, Hkv, D, None, None, torch.bfloat16, 2e-2, timed=True,
                     graph=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(S + Hkv)  # flash_case's inputs
    q = torch.randn(B, S, Hq, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(B, S, Hq, D, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = fa_ops.attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    qp, kp, vp = (t.detach().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(fa_ref.attention_plain(qp, kp, vp, causal=True), (qp, kp, vp),
                               dout)
    rec["bwd_rel_err"] = max(rel_err(a, b) for a, b in zip(grads, want))
    del grads, want, qp, kp, vp
    need(rec["bwd_rel_err"] <= 2e-2, f"flash {name}: backward {rec['bwd_rel_err']}")
    bwd = lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)  # noqa: E731

    def fwd_bwd():
        torch.autograd.grad(fa_ops.attention(q, k, v, causal=True), (q, k, v), dout)

    qh, kh, vh = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    dh = dout.transpose(1, 2)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=Hq != Hkv)
        torch.autograd.grad(o, (qh, kh, vh), dh)

    # in turns, twice: backward, forward plus backward, SDPA's
    runs = [[cuda_ms(fn, iters=10, warmup=2) for fn in (bwd, fwd_bwd, lib_fwd_bwd)]
            for _ in range(2)]
    rec["train_ms_runs"] = runs
    rec["bwd_ms"], rec["fwd_bwd_ms"], rec["library_fwd_bwd_ms"] = (
        sum(r[i] for r in runs) / len(runs) for i in range(3))
    fwd_ops = 4 * D * fa_ops.visible_pairs(S, S, True, None) * B * Hq
    # bytes: q, k, v and dout read, dq, dk, dv written (and out, forward too)
    rec["bwd_bound_ms"], rec["bwd_bound_by"] = bound(2 * nbytes(q, k, v) + nbytes(dout),
                                                     2.5 * fwd_ops, torch.bfloat16)
    rec["fwd_bwd_bound_ms"], rec["fwd_bwd_bound_by"] = bound(
        2 * nbytes(q, k, v) + nbytes(out, dout), 3.5 * fwd_ops, torch.bfloat16)
    print("kernel_time flash_attention_training", json.dumps(
        {key: rec[key] for key in TP_TRAIN_FLASH_KEYS}), flush=True)
    return rec


def tp_train_flash_cases():
    """Flash at one rank's shapes in a tensor-parallel training step of
    internvl2-76b (64/8 heads, D 128) at 8 and 16 model ranks: 8/1 and 4/1
    heads, B 1 x S 2560."""
    return [flash_train_case(TP_TRAIN_FLASH_CASES[0], 1, TP_S, 8, 1, 128),
            flash_train_case(TP_TRAIN_FLASH_CASES[1], 1, TP_S, 4, 1, 128)]


# the scan on one rank's channels of recurrentgemma-9b's 4096 (``rnn_split``):
# training at 16 and 8 model ranks (B 1), its backward's pair at 16, serving
# at 16 (B 4); S 2560
RNN_SCAN_CASES = ("recurrentgemma-9b training, a rank of 16", "recurrentgemma-9b training, "
                  "a rank of 8", "bf16 a, fp32 b: the training backward, a rank of 16",
                  "recurrentgemma-9b prefill, a rank of 16",
                  # serve_2d's chunks of the channels: a rank of (data 2 x model 8) or
                  # (data 4 x model 4), of (data 4 x model 8), of the 16 x 16 mesh
                  "recurrentgemma-9b serve_2d prefill, a rank of 16 (data x model)",
                  "recurrentgemma-9b serve_2d prefill, a rank of (data 4 x model 8)",
                  "recurrentgemma-9b serve_2d prefill, a rank of 16 x 16")
RNN_SCAN_SHAPES = ((1, 256, None), (1, 512, None), (1, 256, torch.float32), (4, 256, None),
                   (1, 256, None), (1, 128, None), (1, 16, None))
RWKV_WKV_CASES = (("rwkv6-7b prefill, a rank of 16", 1, 2560, 4, False),
                  ("rwkv6-7b prefill, a rank of 8", 1, 2560, 8, False),
                  ("rwkv6-7b decode step, a rank of 16", 4, 1, 4, True),
                  # a rank of serve_2d's grids: (data 2 x model 8), (data 4 x model 4)
                  ("rwkv6-7b prefill, a rank of model 4", 1, 2560, 16, False),
                  ("rwkv6-7b decode_32k step, a rank of model 8", 128, 1, 8, True),
                  ("rwkv6-7b decode_32k step, a rank of model 4", 128, 1, 16, True))
RWKV_WKV_KEYS = ("case", "shape", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")
RNN_SCAN_KEYS = ("case", "shape", "dtype", "dtype_b", "route", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")


def kernel_phase():
    flash = flash_case("recurrentgemma-9b prefill", 4, 2560, 16, 1, 256, 2048, None,
                       torch.bfloat16, 2e-2, timed=True, previous=True)
    flash_checks = [
        flash_case("gemma2-9b global, softcap", 2, 2560, 16, 8, 256, None, 50.0,
                   torch.bfloat16, 2e-2, timed=True, previous=True),
        flash_case("mistral-nemo-12b heads", 2, 2560, 32, 8, 128, None, None,
                   torch.bfloat16, 2e-2, timed=True),
        flash_case("qwen3-moe-235b-a22b prefill", 4, 2560, 64, 4, 128, None, None,
                   torch.bfloat16, 2e-2, timed=True),
        flash_case("gemma2-9b local, softcap, ragged", 1, 2500, 16, 8, 256, 2048, 50.0,
                   torch.bfloat16, 2e-2, timed=False),
        # internvl2-76b's prefill: 256 prefix rows + 2304 prompt tokens, 64/8 heads
        flash_case("internvl2-76b prefill", VLM_B, VLM_P + VLM_S, 64, 8, 128, None, None,
                   torch.bfloat16, 2e-2, timed=True, graph=True),
    ] + tp_flash_cases() + tp_train_flash_cases()
    # whisper-medium's three attentions (head_dim 64, 16/16 heads, B 4, 1500
    # frames, 448 tokens), the tensor-core kernel timed beside the CUDA-core one
    whisper = [
        flash_case("whisper-medium encoder", 4, 1500, 16, 16, 64, None, None,
                   torch.bfloat16, 2e-2, timed=True, previous=True, causal=False, graph=True),
        flash_case("whisper-medium decoder", 4, 448, 16, 16, 64, None, None,
                   torch.bfloat16, 2e-2, timed=True, previous=True, graph=True),
        flash_case("whisper-medium cross", 4, 448, 16, 16, 64, None, None,
                   torch.bfloat16, 2e-2, timed=True, previous=True, causal=False, S_k=1500,
                   graph=True),
    ] + whisper_tp_flash_cases()
    simt_checks = [
        flash_case("recurrentgemma-9b heads, fp32", 1, 2560, 16, 1, 256, 2048, None,
                   torch.float32, 1e-5, timed=False),
        flash_case("bf16 at head_dim 32", 2, 300, 8, 2, 32, None, None,
                   torch.bfloat16, 2e-2, timed=False),
    ]
    need([c["kernel"] for c in [flash] + flash_checks + whisper] == ["wgmma"] * 16
         and [c["kernel"] for c in simt_checks] == ["simt"] * 2,
         "flash cases took the wrong kernel")
    lru = rglru_case("recurrentgemma-9b prefill", 4, 2560, 4096, False, torch.bfloat16,
                     timed=True)
    lru_checks = [
        rglru_case("fp32 with h0, ragged", 3, 1001, 4000, True, torch.float32, timed=False),
        rglru_case("bf16 with h0", 2, 517, 4096, True, torch.bfloat16, timed=False),
        rglru_case("bf16, one step past a full ring", 3, 193, 4000, True, torch.bfloat16,
                   timed=False),
        rglru_case("bf16, T inside one stage", 1, 5, 4096, False, torch.bfloat16,
                   timed=False),
        rglru_case("bf16, unaligned C: simple path", 1, 37, 100, True, torch.bfloat16,
                   timed=False),
        # the training backward's call: bf16 decay, fp32 upstream gradient
        rglru_case("bf16 a, fp32 b: recurrentgemma-9b training backward", 2, 2560, 4096,
                   False, torch.bfloat16, timed=True, dtype_b=torch.float32),
        rglru_case("bf16 a, fp32 b, with h0, unaligned C: simple path", 1, 37, 100, True,
                   torch.bfloat16, timed=False, dtype_b=torch.float32),
    ] + [rglru_case(name, B, 2560, C, False, torch.bfloat16, timed=True, dtype_b=dtype_b)
         for name, (B, C, dtype_b) in zip(RNN_SCAN_CASES, RNN_SCAN_SHAPES)]
    need(lru["route"] == "ring" and [c["route"] for c in lru_checks]
         == ["ring"] * 4 + ["simple", "ring", "simple"] + ["ring"] * len(RNN_SCAN_CASES),
         "rglru cases took the wrong path")
    wkv = wkv6_case("rwkv6-7b prefill", 4, 2560, 64, False, torch.bfloat16, timed=True)
    wkv_checks = [
        wkv6_case("fp32 with s0, ragged", 3, 1001, 8, True, torch.float32, timed=False),
        wkv6_case("rwkv6-7b decode step", 4, 1, 64, True, torch.bfloat16, timed=True),
        wkv6_case("bf16, T 1, no state", 2, 1, 64, False, torch.bfloat16, timed=False),
        wkv6_case("bf16 with s0, one step past a chunk", 2, 17, 64, True, torch.bfloat16,
                  timed=False),
        wkv6_case("bf16 with s0, one step past the ring", 2, 49, 64, True,
                  torch.bfloat16, timed=False),
        wkv6_case("bf16, B*H 2 below the SM count", 1, 300, 2, False, torch.bfloat16,
                  timed=False),
    ] + [wkv6_case(name, B, T, H, with_s0, torch.bfloat16, timed=True)
         for name, B, T, H, with_s0 in RWKV_WKV_CASES]
    return (flash, flash_checks, simt_checks, whisper), (lru, lru_checks), (wkv, wkv_checks)


# ---------------------------------------------------------------------------
# Phases 4-6: the model path
# ---------------------------------------------------------------------------

def reset_counts():
    for kern in KERNELS:
        kern.launches = 0


def counts():
    return {kern.name: kern.launches for kern in KERNELS}


def check_outputs(outs, n_req, n_new, vocab):
    need(len(outs) == n_req, f"expected {n_req} outputs, got {len(outs)}")
    for o in outs:
        need(len(o) == n_new and all(0 <= t < vocab for t in o),
             f"bad continuation {o}")


def want_launches(cfg, decode_steps, dtype):
    """Launches of one prefill and ``decode_steps`` decode steps, by layer
    kind: flash (on the kernel ``kernel_for`` picks) and the RG-LRU scan run
    in prefill only, WKV in both."""
    kinds = [cfg.mixer_pattern[i % len(cfg.mixer_pattern)] for i in range(cfg.n_layers)]
    flash = {"wgmma": "flash_attention_wgmma", "simt": "flash_attention"}[
        fa_ops.kernel_for(dtype, cfg.head_dim)]
    want = {kern.name: 0 for kern in KERNELS}
    want[flash] = kinds.count("attn") + kinds.count("attn_local")
    want["rglru_scan"] = kinds.count("rglru")
    want["wkv6"] = kinds.count("rwkv") * (1 + decode_steps)
    return want


def launch_counts(flash=0, flash_wgmma=0, rglru=0, wkv=0):
    return {"flash_attention": flash, "flash_attention_wgmma": flash_wgmma,
            "rglru_scan": rglru, "wkv6": wkv}


def serve_phase(arch, expect):
    """launch.serve.main at full width; ``expect`` is the launch count the
    run must show, written out (not derived) for the full config."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = launch_serve.main(["--arch", arch] + SERVE_FLAGS)
    torch.cuda.synchronize()
    launches = counts()
    cfg, timing = res["cfg"], res["timing"]
    check_outputs(res["outputs"], 4, 16, cfg.vocab_size)
    need(all(2304 <= len(p) <= 2560 for p in res["prompts"]), "prompt lengths")
    dec = timing["decode_s"]
    want = want_launches(cfg, len(dec), torch.bfloat16)
    need(want == expect, f"{arch}: layer kinds give {want}, expected {expect}")
    need(launches == want, f"{arch}: launches {launches}, expected {want}")
    rec = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": res["n_params"], "dtype": res["dtype"], "batch": 4,
        "prompt_lens": [len(p) for p in res["prompts"]],
        "prefill_len": timing["prefill_len"], "prefill_ms": timing["prefill_s"] * 1e3,
        "prefill_tok_per_s": 4 * timing["prefill_len"] / timing["prefill_s"],
        "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
        "decode_ms_per_step_median": 1e3 * float(np.median(dec)),
        "decode_steps": len(dec), "new_tokens": res["tokens"],
        "tok_per_s": res["tokens"] / res["seconds"], "seconds": res["seconds"],
        "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return rec, cfg, timing


def recurrentgemma_serve_phase():
    rec, cfg, timing = serve_phase("recurrentgemma-9b", launch_counts(flash_wgmma=12, rglru=26))
    need(timing["prefill_len"] > cfg.window, "prefill must exceed the window")
    print("serve", json.dumps(rec), flush=True)
    return rec


def rwkv6_serve_phase():
    rec, cfg, _ = serve_phase("rwkv6-7b", launch_counts(wkv=32 + 16 * 32))
    need((cfg.n_layers, cfg.d_model, cfg.n_heads) == (32, 4096, 64), "rwkv6-7b width")
    print("rwkv6", json.dumps(rec), flush=True)
    return rec


def model_check_phase(arch, n_layers, expect, tol):
    """Full width, depth cut to ``n_layers``, fp32: prefill over 2090
    positions and 3 decode steps, logits on the card (kernels) against the
    same weights on the CPU (plain twins)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    lm = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    model = build_model(cfg)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, 2100))
    steps = [toks[:, :2090]] + [toks[:, t:t + 1] for t in range(2090, 2093)]

    def run(model, lm, dev):
        cache = model.init_cache(1, 4096, torch.float32)
        with torch.inference_mode():
            out, cache = model.prefill(lm, {"tokens": torch.from_numpy(steps[0]).to(dev)},
                                       cache)
            outs = [out.float().cpu()]
            for tok in steps[1:]:
                out, cache = model.decode_step(lm, cache, torch.from_numpy(tok).to(dev))
                outs.append(out.float().cpu())
        return torch.cat(outs, dim=1)

    reset_counts()
    on_card = run(model, lm, torch.device("cuda"))
    launches = counts()
    need(launches == expect, f"{arch} check launches {launches}, expected {expect}")
    cpu_lm = LM(cfg, torch.device("cpu"), torch.float32)
    cpu_lm.load_state_dict(lm.state_dict())
    del lm
    torch.cuda.empty_cache()
    on_cpu = run(build_model(cfg, device="cpu"), cpu_lm, torch.device("cpu"))
    err = float((on_card - on_cpu).abs().max())
    rec = {"arch": cfg.name, "layers": n_layers, "dtype": "float32", "prefill_len": 2090,
           "decode_steps": 3, "max_abs_logit": float(on_cpu.abs().max()),
           "max_abs_err": err, "tol": tol, "launches": launches,
           "argmax_equal": bool(torch.equal(on_card.argmax(-1), on_cpu.argmax(-1)))}
    print("model_check", json.dumps(rec), flush=True)
    need(torch.isfinite(on_card).all(), "non-finite logits on the card")
    need(err <= tol, f"card vs CPU logits differ by {err} > {tol}")
    need(rec["argmax_equal"], "card and CPU pick different tokens")
    return rec


def gemma2_phase():
    cfg = dataclasses.replace(get_config("gemma2-9b"), n_layers=4)
    model = build_model(cfg)
    params = model.init(SEED, torch.bfloat16)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(2304, 2561)).tolist()
               for _ in range(4)]
    eng = ServeEngine(model, params, ServeConfig(max_len=4096, max_new_tokens=16,
                                                 cache_dtype=torch.bfloat16))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, rng_seed=SEED)
    dt = time.perf_counter() - t0
    launches = counts()
    check_outputs(outs, 4, 16, cfg.vocab_size)
    need(launches == launch_counts(flash_wgmma=4), f"gemma2 launches {launches}")
    dec = eng.last_timing["decode_s"]
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": sum(p.numel() for p in params.parameters()), "dtype": "bfloat16",
           "prefill_len": eng.last_timing["prefill_len"],
           "prefill_ms": eng.last_timing["prefill_s"] * 1e3,
           "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
           "tok_per_s": sum(len(o) for o in outs) / dt, "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("gemma2", json.dumps(rec), flush=True)
    return rec


MOE_STAGES = ("_route", "_dispatch", "_experts", "_combine")


class StageEvents:
    """Record CUDA events around every call of ``owner.<name>`` for each
    name while in use; ``ms()`` sums each name's spans. The stream runs the
    work in order, so a span is the device time of what was enqueued inside
    it (and any wait for the host, which in a prefill is short)."""

    def __init__(self, owner, names):
        self.owner, self.spans = owner, {n: [] for n in names}
        self.orig = {n: getattr(owner, n) for n in names}

    def _wrap(self, name):
        fn = self.orig[name]

        def run(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.spans[name].append((start, end))
            return out
        return run

    def __enter__(self):
        for name in self.orig:
            setattr(self.owner, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.owner, name, fn)

    def ms(self):
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in spans) for n, spans in self.spans.items()}


def moe_serve_phase(cfg):
    """An MoE config (qwen3-moe-235b-a22b at full width, 8 layers) in bf16,
    through ServeEngine: a cold and a warm batch, then one more prefill
    split by stage. Returns (the record, the weights, the padded prompts
    and the warm batch's tokens, for the ``ep`` phase)."""
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, torch.bfloat16)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(2304, 2561)).tolist()
               for _ in range(4)]
    eng = ServeEngine(model, params, ServeConfig(max_len=4096, max_new_tokens=16,
                                                 cache_dtype=torch.bfloat16))
    prefill, after_prefill = model.prefill, []

    def counted_prefill(*args):
        out = prefill(*args)
        after_prefill.append(counts())
        return out

    model.prefill = counted_prefill
    runs = []
    for _ in range(2):  # cold, then warm
        reset_counts()
        t0 = time.perf_counter()
        outs = eng.generate(prompts, rng_seed=SEED)
        dt = time.perf_counter() - t0
        check_outputs(outs, 4, 16, cfg.vocab_size)
        runs.append((dict(eng.last_timing), counts(), dt, sum(len(o) for o in outs)))
    model.prefill = prefill
    del eng
    per_prefill = launch_counts(flash_wgmma=cfg.n_layers)
    for (_, launches, _, _), at_prefill in zip(runs, after_prefill):
        need(at_prefill == per_prefill, f"moe prefill launches {at_prefill}")
        need(launches == per_prefill, f"moe launches {launches}: decode launched flash")

    # the prefill split by stage, the batch padded as the engine pads it
    plen = max(len(p) for p in prompts)
    toks = torch.zeros(4, plen, dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = torch.tensor(p)
    cache = model.init_cache(4, 4096, torch.bfloat16)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.inference_mode(), StageEvents(MoE, MOE_STAGES) as moe_ev, \
            StageEvents(fa_ops, ["attention"]) as flash_ev:
        start.record()
        model.prefill(params, {"tokens": toks.cuda()}, cache)
        end.record()
        split = {**moe_ev.ms(), "flash": flash_ev.ms()["attention"]}
    prefill_dev_ms = start.elapsed_time(end)
    need(all(len(v) == cfg.n_layers for v in moe_ev.spans.values()), "moe stage calls")
    (cold, _, _, _), (warm, launches, dt, n_tok) = runs
    dec = warm["decode_s"]
    # a decode step reads every layer weight (all 128 experts run, C = 1) and the head
    step_bytes = sum(p.numel() * p.element_size() for n, p in params.named_parameters()
                     if n != "embed")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "experts": cfg.n_experts, "top_k": cfg.experts_per_token,
           "params": sum(p.numel() for p in params.parameters()), "dtype": "bfloat16",
           "batch": 4, "prompt_lens": [len(p) for p in prompts], "prefill_len": plen,
           "prefill_ms_cold": cold["prefill_s"] * 1e3, "prefill_ms": warm["prefill_s"] * 1e3,
           "prefill_tok_per_s": 4 * plen / warm["prefill_s"],
           "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
           "decode_ms_per_step_median": 1e3 * float(np.median(dec)),
           "decode_ms_per_step_cold": 1e3 * sum(cold["decode_s"]) / len(cold["decode_s"]),
           "decode_step_weight_bytes": step_bytes,
           "decode_step_bytes_bound_ms": step_bytes / roofline.HBM_BW * 1e3,
           "new_tokens": n_tok, "tok_per_s": n_tok / dt, "seconds": dt,
           "launches": launches, "launches_per_prefill": after_prefill[-1],
           "prefill_device_ms": prefill_dev_ms,
           "prefill_split_ms": {k.lstrip("_"): v for k, v in split.items()},
           "prefill_split_share": {k.lstrip("_"): v / prefill_dev_ms for k, v in split.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("moe_serve", json.dumps(rec), flush=True)
    return rec, {"cfg": cfg, "params": params, "tokens": toks,
                 "outputs": torch.tensor(outs, dtype=torch.long)}


# ---------------------------------------------------------------------------
# Phases 8c-8f: whisper-medium, the encoder-decoder
# ---------------------------------------------------------------------------

WHISPER_B, WHISPER_T, WHISPER_S = 4, 1500, 448  # 30 s of audio; the decoder's context
WHISPER_DECODE_STEPS = 64
WHISPER_START = 50258  # <|startoftranscript|> in whisper's vocabulary


def whisper_cfg(n_layers=None):
    """whisper-medium at full width; ``n_layers`` cuts both stacks."""
    cfg = get_config("whisper-medium")
    need((cfg.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
          cfg.head_dim, cfg.frontend_seq_len, cfg.max_seq_len)
         == (24, 24, 1024, 16, 16, 64, 1500, 448), "whisper-medium width")
    if n_layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=n_layers, n_encoder_layers=n_layers)


def whisper_serve_phase(encoder_case):
    """whisper-medium at full width in bf16 through the model API (the
    reference's engine cannot serve it): an encode of 4 x 1500 frames, cold
    then warm under CUDA events (the warm one with each flash call's span),
    then 64 greedy decode steps from the start token. ``encoder_case``: the
    kernel phase's encoder-shape record, whose CUDA-core time puts a figure
    on the old route's share of an encode."""
    cfg = whisper_cfg()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.randn(WHISPER_B, WHISPER_T, cfg.d_model, generator=g,
                         device="cuda").bfloat16()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    encode_ms, per_encode = [], []
    with torch.inference_mode():
        for warm in (False, True):
            cache = model.init_cache(WHISPER_B, cfg.max_seq_len, torch.bfloat16)
            reset_counts()
            with StageEvents(fa_ops, ["attention"]) as flash_ev:
                start.record()
                memory, cache = model.prefill(params, {"frames": frames}, cache)
                end.record()
                flash_ms = flash_ev.ms()["attention"]
            encode_ms.append(start.elapsed_time(end))
            per_encode.append(counts())
        for launches in per_encode:
            need(launches == launch_counts(flash_wgmma=cfg.n_encoder_layers),
                 f"whisper encode launches {launches}")
        need(len(flash_ev.spans["attention"]) == cfg.n_encoder_layers, "whisper flash calls")
        need(memory.shape == frames.shape and bool(torch.isfinite(memory).all()),
             "whisper memory: shape or non-finite values")
        reset_counts()
        tok = torch.full((WHISPER_B, 1), WHISPER_START, device="cuda")
        out = []
        t0 = time.perf_counter()
        start.record()
        for _ in range(WHISPER_DECODE_STEPS):
            logits, cache = model.decode_step(params, cache, tok, memory)
            tok = logits.argmax(-1)
            out.append(tok)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    decode_launches = counts()
    need(decode_launches == launch_counts(), f"whisper decode launched {decode_launches}")
    need(bool(torch.isfinite(logits).all()), "whisper decode: non-finite logits")
    toks = torch.cat(out, dim=1).cpu()
    need(toks.shape == (WHISPER_B, WHISPER_DECODE_STEPS) and cache["pos"] == WHISPER_DECODE_STEPS
         and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "whisper decode tokens")
    old_ms = encoder_case["previous_ms"] * cfg.n_encoder_layers
    rec = {"arch": cfg.name, "layers": [cfg.n_encoder_layers, cfg.n_layers],
           "d_model": cfg.d_model, "params": sum(p.numel() for p in params.parameters()),
           "dtype": "bfloat16", "batch": WHISPER_B, "frames": WHISPER_T,
           "encode_ms_cold": encode_ms[0], "encode_ms": encode_ms[1],
           "encode_frames_per_s": WHISPER_B * WHISPER_T / (encode_ms[1] * 1e-3),
           "encode_flash_ms": flash_ms, "encode_flash_share": flash_ms / encode_ms[1],
           "decode_steps": WHISPER_DECODE_STEPS,
           "decode_ms_per_step": wall * 1e3 / WHISPER_DECODE_STEPS,
           "decode_device_ms_per_step": start.elapsed_time(end) / WHISPER_DECODE_STEPS,
           "tok_per_s": WHISPER_B * WHISPER_DECODE_STEPS / wall,
           "first_tokens": toks[:, :8].tolist(),
           "launches_per_encode": per_encode[-1], "launches_decode": decode_launches,
           "simt_encoder_ms_x_layers": old_ms,
           "simt_share_of_warm_encode": old_ms / (encode_ms[1] - flash_ms + old_ms),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("whisper_serve", json.dumps(rec), flush=True)
    return rec


def whisper_check_phase(tol):
    """whisper-medium at full width cut to 2 + 2 layers, fp32: the encode's
    memory (2 x 1500 frames), the teacher-forced logits over 448 tokens and
    8 decode steps fed the same tokens, on the card (the CUDA-core flash
    kernel) against the same weights on the CPU (the plain path)."""
    cfg = whisper_cfg(2)
    params = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.standard_normal((2, WHISPER_T, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, WHISPER_S)))

    def run(params, dev):
        model = build_model(cfg, device=dev)
        marks = [counts()]
        with torch.inference_mode():
            memory, cache = model.prefill(params, {"frames": frames.to(dev)},
                                          model.init_cache(2, WHISPER_S, torch.float32))
            marks.append(counts())
            logits = params.decode_train(toks.to(dev), memory)
            marks.append(counts())
            steps = [model.decode_step(params, cache, toks[:, t:t + 1].to(dev), memory)[0].cpu()
                     for t in range(8)]
            marks.append(counts())
        launches = [{k: b[k] - a[k] for k in a} for a, b in zip(marks, marks[1:])]
        return memory.cpu(), logits.cpu(), torch.cat(steps, dim=1), launches

    reset_counts()
    card = run(params, torch.device("cuda"))
    cpu_params = copy.deepcopy(params).to("cpu")
    del params
    torch.cuda.empty_cache()
    cpu = run(cpu_params, torch.device("cpu"))
    need(card[3] == [launch_counts(flash=2), launch_counts(flash=4), launch_counts()],
         f"whisper check launches {card[3]}")
    errs = {name: float((a - b).abs().max())
            for name, a, b in zip(("memory", "logits", "decode_logits"), card, cpu)}
    argmax_equal = bool(torch.equal(card[2].argmax(-1), cpu[2].argmax(-1)))
    rec = {"arch": cfg.name, "layers": [2, 2], "dtype": "float32", "batch": 2,
           "frames": WHISPER_T, "tokens": WHISPER_S, "decode_steps": 8,
           "max_abs_err": errs, "tol": tol, "max_abs_logit": float(cpu[1].abs().max()),
           "decode_argmax_equal": argmax_equal,
           "teacher_vs_decode_max_abs": float((cpu[2] - cpu[1][:, :8]).abs().max()),
           "launches": dict(zip(("encode", "decode_train", "decode"), card[3]))}
    print("whisper_check", json.dumps(rec), flush=True)
    need(all(bool(torch.isfinite(t).all()) for t in card[:3]), "whisper check: non-finite")
    need(max(errs.values()) <= tol, f"whisper card vs CPU differ by {errs} > {tol}")
    need(argmax_equal, "whisper: card and CPU decode pick different tokens")
    need(rec["teacher_vs_decode_max_abs"] <= tol, "whisper: decode disagrees with teacher forcing")
    return rec


def whisper_train_check_phase(loss_tol, grad_tol):
    """2 + 2 layers at full width, fp32, B 1 x 1500 frames x 448 tokens,
    remat "nothing" (each block a checkpoint: flash in the forward and again
    in the recompute): the loss and every gradient, card against CPU. A key
    bias's gradient is 0 exactly (softmax does not see a shift shared by
    every key), so each side's is rounding noise: it is held to grad_tol of
    the same layer's wk gradient instead of to its own size."""
    cfg = whisper_cfg(2)
    params = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    batch = {"frames": rng.standard_normal((1, WHISPER_T, cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (1, WHISPER_S)),
             "labels": rng.integers(0, cfg.vocab_size, (1, WHISPER_S))}

    def loss_and_grads(params, dev):
        params.requires_grad_(True)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, _ = build_model(cfg, device=dev).loss(params, tb, remat_policy="nothing")
        names, ps = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, ps)
        return float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)}

    reset_counts()
    loss, grads = loss_and_grads(params, torch.device("cuda"))
    torch.cuda.synchronize()
    launches = counts()
    need(launches == launch_counts(flash=2 * (2 + 2 * 2)),
         f"whisper train check launches {launches}")
    cpu_params = copy.deepcopy(params).to("cpu")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_grads(cpu_params, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    key_bias = [n for n in cpu_grads if n.endswith(".bk")]
    rel = {n: float((grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
           for n, g in cpu_grads.items() if n not in key_bias}
    bias_rel = {n: max(float(grads[n].abs().max()), float(cpu_grads[n].abs().max()))
                / float(cpu_grads[n[:-2] + "wk"].abs().max()) for n in key_bias}
    worst = max(rel, key=rel.get)
    rec = {"arch": cfg.name, "layers": [2, 2], "dtype": "float32", "batch": 1,
           "frames": WHISPER_T, "tokens": WHISPER_S, "remat_policy": "nothing",
           "loss": loss, "cpu_loss": cpu_loss, "loss_abs_err": abs(loss - cpu_loss),
           "loss_tol": loss_tol, "worst_leaf": worst, "worst_leaf_rel_err": rel[worst],
           "grad_tol": f"{grad_tol} * max|g| per leaf", "leaves": len(rel) + len(key_bias),
           "key_bias_noise_over_wk": max(bias_rel.values()), "launches": launches,
           "cpu_s": cpu_s}
    print("whisper_train_check", json.dumps(rec), flush=True)
    need(np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
         "whisper train check: non-finite loss or gradient")
    need(abs(loss - cpu_loss) <= loss_tol, f"whisper: card vs CPU loss {loss} vs {cpu_loss}")
    need(rel[worst] <= grad_tol, f"whisper: gradient of {worst} off by {rel[worst]}")
    need(max(bias_rel.values()) <= grad_tol, f"whisper: key-bias gradients {bias_rel}")
    return rec


def whisper_train_phase():
    """whisper-medium at full width (24 + 24 layers), bf16 compute over fp32
    masters, remat "nothing", AdamW, B 4 x 1500 frames x 448 tokens: a cold
    step, then the timed one (CUDA events); 24 + 2 x 24 tensor-core flash
    launches a step in the forward and as many in the recompute."""
    cfg = whisper_cfg()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"frames": torch.randn(WHISPER_B, WHISPER_T, cfg.d_model, generator=g,
                                   device="cuda").bfloat16(),
             "tokens": torch.randint(0, cfg.vocab_size, (WHISPER_B, WHISPER_S), generator=g,
                                     device="cuda"),
             "labels": torch.randint(0, cfg.vocab_size, (WHISPER_B, WHISPER_S), generator=g,
                                     device="cuda")}
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1), total_steps=2,
                         warmup_steps=1, remat_policy="nothing", compute_dtype=torch.bfloat16)
    train_step, opt_init = make_train_step(model, run)
    state = opt_init(params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    step_ms, losses, launches = [], [], []
    for _ in range(2):  # cold, then the timed step
        reset_counts()
        start.record()
        params, state, metrics = train_step(params, state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        launches.append(counts())
    per_step = 2 * (cfg.n_encoder_layers + 2 * cfg.n_layers)
    for n in launches:
        need(n == launch_counts(flash_wgmma=per_step), f"whisper train launches {n}")
    need(all(np.isfinite(losses)) and state.step == 2, f"whisper train: losses {losses}")
    # model FLOPs: 6 x parameters x tokens for each stack's products (the
    # tied head counted with the decoder), and attention's 4 D Hq a visible
    # pair forward, twice that backward; remat's recompute is not model work
    enc, dec = (sum(p.numel() for p in blocks.parameters())
                for blocks in (params.enc_blocks, params.dec_blocks))
    head = cfg.vocab_size * cfg.d_model
    B, T, S = WHISPER_B, WHISPER_T, WHISPER_S
    dense = 6 * (enc * B * T + (dec + head) * B * S)
    pairs = (cfg.n_encoder_layers * fa_ops.visible_pairs(T, T, False, None)
             + cfg.n_layers * (fa_ops.visible_pairs(S, S, True, None) + fa_ops.visible_pairs(S, T, False, None)))
    attn = 3 * 4 * cfg.head_dim * cfg.n_heads * pairs * B
    rec = {"arch": cfg.name, "layers": [cfg.n_encoder_layers, cfg.n_layers],
           "params": sum(p.numel() for p in params.parameters()), "compute_dtype": "bfloat16",
           "master_dtype": "float32", "remat_policy": run.remat_policy, "batch": B,
           "frames": T, "tokens": S, "losses": losses, "step_ms_cold": step_ms[0],
           "step_ms": step_ms[1], "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step": launches[-1], "model_flops_per_step": dense + attn,
           "model_flops_share_of_bf16_peak":
               (dense + attn) / (step_ms[1] * 1e-3) / roofline.PEAK_OPS_PER_S[torch.bfloat16]}
    print("whisper_train", json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# Phase 10b: sharded whisper-medium training on the model axis
# ---------------------------------------------------------------------------

WHISPER_TP_RANKS = (4, 16)
# shares: outputs and gradients within 1e-5 of each one's largest in fp32, 5e-2
# in bf16; the 1-rank path's losses within 1e-6 of train_loop's
WHISPER_TP_FP32_TOL, WHISPER_TP_BF16_TOL, WHISPER_TP_LOSS_RTOL = 1e-5, 5e-2, 1e-6
WHISPER_TP_STEPS = 3
# (c) the sequence form: (W, frames, form); 448 tokens split at 4 and 16
# ranks, 1500 frames (30 s of audio) at 4 and not at 16, train_4k's 4096 at 16
WHISPER_TP_SEQ_SETTINGS = ((4, WHISPER_T, "sequence"), (16, WHISPER_T, "sequence"),
                           (16, 4096, "sequence"))


def whisper_grad_errs(got, want):
    """rel_err of each output and gradient; a key bias's gradient (0 exactly,
    rounding noise on both sides) over its layer's largest wk gradient."""
    return {k: (max(float(got[k].float().abs().max()), float(want[k].float().abs().max()))
                / float(want[k[:-2] + "wk"].float().abs().max())) if k.endswith(".bk")
            else rel_err(got[k], want[k]) for k in want}


def whisper_tp_shares(settings, line="whisper_tp_shares"):
    """One full-width encoder block (B 1 x T frames) and one decoder block
    (B 1 x 448 tokens, a T-frame memory), fp32 then the same weights in
    bf16: the unsplit block's output and gradients from one upstream
    gradient, then for each (W, T, form) in ``settings`` every rank's share
    in turn (``tensor_parallel.block_shares``: its weight blocks, the split
    parts' terms added in fp32, each part's normed input and the memory
    reaching every rank through a cast from fp32), one backward; the output,
    the input's and the memory's gradients and every leaf's against the
    unsplit block's. (a) the plain form: every rank holds the whole stream.
    (c) the sequence form (``share(..., seq_len=)`` with both streams'
    lengths): where the axis divides a block's stream, each rank
    normalizes its own positions, the normed blocks concatenated are every
    rank's gathered input and the summed terms are sliced to each rank's
    positions; a stream it does not divide (1500 frames at 16 ranks) stays
    whole, the plain form."""
    cfg = whisper_cfg(1)
    d = cfg.d_model
    recs = []
    for T in dict.fromkeys(t for _, t, _ in settings):
        model = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
        g = torch.Generator(device="cuda").manual_seed(SEED + 2)
        inputs = {"enc_blocks": [torch.randn(1, T, d, generator=g, device="cuda")],
                  "dec_blocks": [torch.randn(1, WHISPER_S, d, generator=g, device="cuda"),
                                 torch.randn(1, T, d, generator=g, device="cuda")]}
        upstream = {k: torch.randn(v[0].shape, generator=g, device="cuda")
                    for k, v in inputs.items()}
        lengths = {"enc_blocks": T, "dec_blocks": WHISPER_S}
        unsplit32 = {}
        for dtype in (torch.float32, torch.bfloat16):
            model.to(dtype).requires_grad_(True)
            kernel = {"wgmma": "flash_wgmma",
                      "simt": "flash"}[fa_ops.kernel_for(dtype, cfg.head_dim)]
            for stack, xs in inputs.items():
                names = [n for n, _ in model.named_parameters() if n.startswith(f"{stack}.0.")]
                leaves = [model.get_parameter(n) for n in names]
                xs = [x.to(dtype).requires_grad_() for x in xs]
                keys = ["output", "input", "memory"][:len(xs) + 1] + names
                positions = torch.arange(xs[0].shape[1], device="cuda")
                gy = upstream[stack].to(dtype)
                reset_counts()
                out = getattr(model, stack)[0](xs[0], positions, *xs[1:])
                want = dict(zip(keys, [out.detach()] + list(
                    torch.autograd.grad(out, xs + leaves, gy))))
                want_launches = counts()
                del out
                unsplit32.setdefault(stack, want)
                n_attn = len(xs)  # flash calls a rank: self-attention (and cross-attention)
                for W, _, form in (s for s in settings if s[1] == T):
                    seq_len = lengths if form == "sequence" else None
                    shares = [tp.share(model, None, r, W, seq_len=seq_len) for r in range(W)]
                    split = shares[0][0].on(stack).seq
                    need((split is not None) == (form == "sequence"
                                                 and xs[0].shape[1] % W == 0),
                         f"whisper {stack} at {W} ({form}, {T} frames): the stream's split "
                         f"{split}")
                    reset_counts()
                    out = tp.block_shares(model, stack, 0, shares, xs[0], positions,
                                          xs[1] if len(xs) > 1 else None)
                    got = dict(zip(keys, [out.detach()] + list(
                        torch.autograd.grad(out, xs + leaves, gy))))
                    torch.cuda.synchronize()
                    launches = counts()
                    del out
                    view = shares[0][0].layer(0, stack)
                    need(view.attn_sum and view.mlp_sum and (view.xattn_sum or n_attn == 1),
                         f"whisper {stack} at {W}: no split")
                    err = whisper_grad_errs(got, want)
                    outputs = keys[:len(xs) + 1]
                    worst = max(names, key=err.get)
                    tol = WHISPER_TP_FP32_TOL if dtype == torch.float32 else WHISPER_TP_BF16_TOL
                    rec = {"case": f"{cfg.name} {stack}.0 ({cfg.n_heads} heads, d_ff {cfg.d_ff})",
                           "model_ranks": W, "form": form, "dtype": str(dtype)[6:],
                           "rows": list(xs[0].shape[:2]), "memory_frames":
                               T if len(xs) > 1 else None, "terms_added_in": "float32",
                           "stream_split": None if split is None else [split.lo, split.hi],
                           "rank_heads": cfg.n_heads // W, "rank_d_ff": cfg.d_ff // W,
                           "summed_gradients": sorted(n for n in names
                                                      if shares[0][0].sums_gradient(n)),
                           "rel_err": {k: err[k] for k in outputs}, "worst_leaf": worst,
                           "worst_leaf_rel_err": err[worst], "leaves": len(names), "tol": tol,
                           "launches_shares": launches, "launches_unsplit": want_launches}
                    if dtype == torch.bfloat16:
                        for tag, side in (("unsplit_vs_fp32", want), ("shares_vs_fp32", got)):
                            e = whisper_grad_errs(side, unsplit32[stack])
                            leaf = max(names, key=e.get)
                            rec[tag] = {**{k: e[k] for k in outputs}, "worst_leaf": e[leaf],
                                        "worst_leaf_name": leaf}
                    print(line, json.dumps(rec), flush=True)
                    need(want_launches == launch_counts(**{kernel: n_attn})
                         and launches == launch_counts(**{kernel: n_attn * W}),
                         f"whisper tp shares {stack} at {W} ({form}, {dtype}): launches "
                         f"{launches}, unsplit {want_launches}")
                    need(all(torch.isfinite(v.float()).all() for v in got.values()),
                         f"whisper tp shares {stack} at {W} ({form}): non-finite")
                    need(max(err.values()) <= tol,
                         f"whisper tp shares {stack} at {W} ({form}, {T} frames, {dtype}): "
                         f"{rec['rel_err']}, {worst} {err[worst]}")
                    recs.append(rec)
                    del shares, got
                del want
        del model, unsplit32, inputs
        torch.cuda.empty_cache()
    return recs


def whisper_tp_path():
    """(b) whisper-medium at 1 + 1 layers, bf16 over fp32 masters, remat
    "nothing", B 4 x 1500 frames x 448 tokens: ``train_loop`` unsharded, then
    ``launch/steps.build_train_step`` (``ShardedModel``) on a 1-rank NCCL mesh
    from the same seeded weights and batch, its optimizer settings; the
    losses, step ms under CUDA events and the flash launches a step (the
    encoder's self-attention and the decoder's two, forward and recompute:
    6)."""
    cfg = whisper_cfg(1)
    cell = shapes.ShapeCell("whisper_tp", WHISPER_T, WHISPER_B, "train")

    def timed(step_fn):
        events, losses, launches = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WHISPER_TP_STEPS):
            reset_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            metrics = step_fn()
            ev[1].record()
            events.append(ev)
            losses.append(float(metrics["loss"]))
            launches.append(counts())
        torch.cuda.synchronize()
        return {"losses": losses, "launches": launches[-1],
                "step_ms": [a.elapsed_time(b) for a, b in events],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        step = steps.build_train_step(cfg, cell, mesh, device="cuda", seed=SEED)
        need(all(isinstance(p, DTensor) for p in step.args[0].parameters()),
             "whisper: the train step is not sharded")
        batch = step.args[2]
        run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1),
                             remat_policy="nothing", compute_dtype=torch.bfloat16)
        model = build_model(cfg)
        lm = model.init(SEED, torch.float32)
        train_step, opt_init = make_train_step(model, run)
        state = [lm, opt_init(lm)]

        def unsharded_step():
            state[0], state[1], metrics = train_step(state[0], state[1], batch)
            return metrics

        unsharded = timed(unsharded_step)
        n_params = sum(p.numel() for p in lm.parameters())
        del state, lm, train_step
        torch.cuda.empty_cache()
        args = list(step.args)

        def sharded_step():
            args[0], args[1], metrics = step.fn(*args)
            return metrics

        sharded = timed(sharded_step)
        del args, step
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(sharded["losses"], unsharded["losses"])]
    per_step = launch_counts(flash_wgmma=2 * 3)
    rec = {"arch": cfg.name, "layers": [1, 1], "params": n_params, "batch": WHISPER_B,
           "frames": WHISPER_T, "tokens": WHISPER_S, "steps": WHISPER_TP_STEPS,
           "compute_dtype": "bfloat16", "master_dtype": "float32", "remat_policy": "nothing",
           "mesh": {"data": 1, "model": 1}, "strategy": "fsdp_tp", "unsharded": unsharded,
           "sharded": sharded, "loss_max_rel_err": max(rel), "loss_tol": WHISPER_TP_LOSS_RTOL,
           "losses_bit_equal": sharded["losses"] == unsharded["losses"],
           "launches_per_step_expected": per_step,
           "step_ms_median_warm": {k: float(np.median(r["step_ms"][1:]))
                                   for k, r in (("unsharded", unsharded),
                                                ("sharded", sharded))}}
    print("whisper_tp_path", json.dumps(rec), flush=True)
    need(unsharded["launches"] == per_step and sharded["launches"] == per_step,
         f"whisper tp path launches {unsharded['launches']}, {sharded['launches']}; "
         f"expected {per_step}")
    need(all(np.isfinite(sharded["losses"])) and max(rel) <= WHISPER_TP_LOSS_RTOL,
         f"whisper tp path: sharded losses {sharded['losses']} against "
         f"{unsharded['losses']}")
    return rec


def whisper_tp_train_phase():
    plain = [(W, WHISPER_T, "plain") for W in WHISPER_TP_RANKS]
    return {"shares": whisper_tp_shares(plain), "path": whisper_tp_path(),
            "seq_shares": whisper_tp_shares(WHISPER_TP_SEQ_SETTINGS, "whisper_tp_seq_shares")}


# ---------------------------------------------------------------------------
# Phase 10c: sharded whisper-medium serving on the model axis
# ---------------------------------------------------------------------------

# (a) shares: 16 decode steps of one decoder block over a 448-slot self cache;
# (b) the 1-rank path: the memory and every call's logits within 1e-3 of the
# unsharded ones' largest, 64 decode steps
WHISPER_SERVE_SHARE_STEPS, WHISPER_SERVE_PATH_TOL = 16, 1e-3
# (b) the same mesh under serve_2d: 16 greedy decode calls after the first
WHISPER_SERVE_2D_STEPS = 16
# (d) serve_2d's grids in threads: an encode of B 1 x 1500 frames, then 4 decode
# steps from position 26 of a seeded 448-slot self cache (28 positions a rank
# of 16: the steps cross a rank's block)
WHISPER_GRID_START, WHISPER_GRID_STEPS = 26, 4
# (a) the encode in the sequence form: (W, frames); 1500 frames (30 s of
# audio) split at 4 ranks and stay whole at 16, train_4k's 4096 split at 16
WHISPER_ENCODE_SEQ_SETTINGS = ((4, WHISPER_T), (16, WHISPER_T), (16, 4096))
# (c) a decoder block's decode fed a memory split along model over 4 ranks
WHISPER_SPLIT_MEMORY_RANKS = 4
# one rank's flash call in the sharded encode: B 4 x 1500 frames on 4 and 1
# of the 16 heads, D 64, bf16, non-causal (kernels phase)
WHISPER_TP_FLASH_CASES = ("whisper-medium encode, a rank of 4", "whisper-medium encode, "
                          "a rank of 16")


def whisper_tp_flash_cases():
    return [flash_case(name, WHISPER_B, WHISPER_T, h, h, 64, None, None, torch.bfloat16, 2e-2,
                       timed=True, causal=False, graph=True)
            for name, h in zip(WHISPER_TP_FLASH_CASES, (4, 1))]


SEQ_DECODE_STEPS = 16


def seeded_cache(api, batch, length, dtype, seed):
    """``api.init_cache(batch, length)`` with every K/V leaf drawn from
    ``seed`` (in fp32, then cast): a cache as earlier steps left it."""
    cache = api.init_cache(batch, length, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    for c in cache[tp.cache_key(cache)]:
        for leaf in c.values():
            leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda"))
    return cache


def seq_decode_form(case, model, stack, cache, steps_in, extra, W, dtype, tol, unsplit32):
    """Block 0 of ``model``'s ``stack`` decoding ``steps_in`` over the whole
    seeded ``cache``, unsplit and then on all W ranks at once, one thread a
    rank on the card (``tensor_parallel.thread_shares`` under ``fsdp_tp``,
    whose cache layout is kept: the cache split by positions over
    ``model``, the new K/V row and every head's queries all-gathered, the
    ranks' partial softmaxes merged by the threads' all-reduces). The steps
    start 8 positions before the last rank's block, so the new rows land
    in two blocks and every block holds valid positions. Every rank's
    output against the unsplit one (within ``tol`` of its largest; ranks
    equal), each rank's cache block against those positions of the unsplit
    cache; ``unsplit32``: the fp32 unsplit outputs by W, filled in fp32 and
    read in bf16. Decode takes the plain path: no kernel launches."""
    key = tp.cache_key(cache)
    L, n = cache[key][0]["k"].shape[1], len(steps_in)
    start = L - L // W - n // 2

    def decode(block, layer, c):
        return torch.stack([block.decode(x, start + t, c[key][0], *extra, axis=layer)
                            for t, x in enumerate(steps_in)]), None if layer is None else layer.seq

    with torch.no_grad():
        want_cache = copy.deepcopy(cache)
        want, _ = decode(getattr(model, stack)[0], None, want_cache)
        torch.cuda.synchronize()
        reset_counts()
        got, caches = tp.thread_shares(model, stack, 0, W, cache, decode)
        torch.cuda.synchronize()
    launches = counts()
    seqs = [seq for _, seq in got]
    got = [out for out, _ in got]
    unsplit32.setdefault(W, want.float())
    cache_err = max(rel_err(c[key][0][k], want_cache[key][0][k][:, seq.lo:seq.hi])
                    for c, seq in zip(caches, seqs) for k in ("k", "v"))
    rec = {"case": case, "form": "sequence-split cache, ranks run together (threads)",
           "model_ranks": W, "dtype": str(dtype)[6:], "batch": int(steps_in[0].shape[0]),
           "cache_len": L, "start": start, "steps": n,
           "rank_positions": [[s.lo, s.hi] for s in seqs],
           "ranks_equal": all(torch.equal(o, got[0]) for o in got),
           "rel_err_per_step": [rel_err(a, b) for a, b in zip(got[0], want)],
           "cache_rel_err": cache_err, "tol": tol, "launches": launches}
    rec["rel_err"] = max(rec["rel_err_per_step"])
    if dtype == torch.bfloat16:
        rec["unsplit_vs_fp32"] = rel_err(want, unsplit32[W])
        rec["shares_vs_fp32"] = rel_err(got[0], unsplit32[W])
    print("seq_decode_form", json.dumps(rec), flush=True)
    need(all(s is not None and s.hi - s.lo == L // W for s in seqs),
         f"{case} at {W}: the cache does not split by positions: {rec['rank_positions']}")
    need(launches == launch_counts(), f"{case} at {W}: launches {launches}")
    need(rec["ranks_equal"] and bool(torch.isfinite(got[0].float()).all())
         and rec["rel_err"] <= tol and cache_err <= tol,
         f"{case} at {W} ({dtype}): {rec['rel_err']}, cache {cache_err}, ranks equal "
         f"{rec['ranks_equal']}")
    return rec


def whisper_serve_shares(ranks):
    """(a) one full-width decoder block's decode, B 4, 16 steps from an empty
    448-slot self cache over a 1500-frame memory, fp32 then the same weights
    in bf16: the unsplit ``DecBlock.decode``, then for each W in ``ranks``
    every rank's share in turn (``tensor_parallel.share`` on the card: its
    heads' block of the self cache, its cross-attention heads, its ``d_ff``
    block; ``block_shares(..., pos=t)``, the split parts' terms added in
    fp32); every step's output against the unsplit block's, each rank's
    cache block against that block of the unsplit cache. Then the sequence
    form at each W (``seq_decode_form``: a seeded 448-slot self cache split
    by positions, the ranks run together, their partial softmaxes merged).
    Decode takes the plain path: no kernel launches on either side."""
    cfg = whisper_cfg(1)
    model = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    api = build_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    d, B, L = cfg.d_model, WHISPER_B, WHISPER_S
    memory = torch.randn(B, WHISPER_T, d, generator=g, device="cuda")
    xs = [torch.randn(B, 1, d, generator=g, device="cuda")
          for _ in range(WHISPER_SERVE_SHARE_STEPS)]
    block = model.dec_blocks[0]
    recs, unsplit32, seq32, split32 = [], None, {}, {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            model.to(dtype)
            mem, steps_in = memory.to(dtype), [x.to(dtype) for x in xs]
            want_cache = api.init_cache(B, L, dtype)
            reset_counts()
            want = torch.stack([block.decode(x, t, want_cache["self"][0], mem)
                                for t, x in enumerate(steps_in)])
            torch.cuda.synchronize()
            want_launches = counts()
            unsplit32 = want if unsplit32 is None else unsplit32
            for W in ranks:
                shares = [tp.share(model, api.init_cache(B, L, dtype), r, W) for r in range(W)]
                reset_counts()
                got = torch.stack([tp.block_shares(model, "dec_blocks", 0, shares, x, None,
                                                   mem, pos=t)
                                   for t, x in enumerate(steps_in)])
                torch.cuda.synchronize()
                launches = counts()
                layers = [axis.layer(0, "dec_blocks") for axis, _, _ in shares]
                need(all(v.attn_sum and v.xattn_sum and v.mlp_sum and v.kv is not None
                         and v.cross.kv is not None for v in layers),
                     f"whisper serve shares at {W}: no split")
                cache_err = max(rel_err(c["self"][0][k],
                                        want_cache["self"][0][k][:, :, v.kv.lo:v.kv.hi])
                                for v, (_, _, c) in zip(layers, shares) for k in ("k", "v"))
                tol = WHISPER_TP_FP32_TOL if dtype == torch.float32 else WHISPER_TP_BF16_TOL
                rec = {"case": f"{cfg.name} dec_blocks.0 decode ({cfg.n_heads} heads, "
                               f"d_ff {cfg.d_ff})",
                       "model_ranks": W, "dtype": str(dtype)[6:], "batch": B,
                       "cache_len": L, "steps": WHISPER_SERVE_SHARE_STEPS,
                       "memory_frames": WHISPER_T, "terms_added_in": "float32",
                       "rank_heads": cfg.n_heads // W, "rank_d_ff": cfg.d_ff // W,
                       "rel_err_per_step": [rel_err(a, b) for a, b in zip(got, want)],
                       "cache_rel_err": cache_err, "tol": tol,
                       "launches_shares": launches, "launches_unsplit": want_launches}
                rec["rel_err"] = max(rec["rel_err_per_step"])
                if dtype == torch.bfloat16:
                    rec["unsplit_vs_fp32"] = rel_err(want, unsplit32)
                    rec["shares_vs_fp32"] = rel_err(got, unsplit32)
                print("whisper_serve_shares", json.dumps(rec), flush=True)
                need(launches == launch_counts() and want_launches == launch_counts(),
                     f"whisper serve shares at {W}: launches {launches}, {want_launches}")
                need(bool(torch.isfinite(got.float()).all()) and rec["rel_err"] <= tol
                     and cache_err <= tol,
                     f"whisper serve shares at {W} ({dtype}): {rec['rel_err']}, cache "
                     f"{cache_err}")
                recs.append(rec)
                del shares, got
                recs.append(seq_decode_form(
                    rec["case"], model, "dec_blocks", seeded_cache(api, B, L, dtype, SEED + 5),
                    steps_in, (mem,), W, dtype, tol, seq32))
                if W == WHISPER_SPLIT_MEMORY_RANKS:
                    recs.append(split_memory_decode(
                        rec["case"], model, seeded_cache(api, B, L, dtype, SEED + 7), steps_in,
                        mem, W, dtype, tol, split32))
    del model
    torch.cuda.empty_cache()
    return recs


class CountingComm:
    """A rank's comm that counts the all-gathers of tensors of ``shape``."""

    def __init__(self, comm, shape):
        self.comm, self.shape, self.n = comm, tuple(shape), 0

    def __getattr__(self, name):
        return getattr(self.comm, name)

    def all_gather(self, x, dim, axis):
        self.n += tuple(x.shape) == self.shape
        return self.comm.all_gather(x, dim, axis)


def split_memory_decode(case, model, cache, steps_in, memory, W, dtype, tol, unsplit32):
    """(c) Decoder block 0 decoding ``steps_in`` on all W ranks at once, one
    thread a rank (``tensor_parallel.thread_shares`` under ``fsdp_tp`` with
    ``seq_len={"enc_blocks": T_f}``): each rank holds its block of the
    memory's frames, as the sharded encode leaves it (``Shard(1)`` on
    ``model``), and gathers it once a step before the block
    (``ModelAxis.memory_in``: one all-gather, counted), then decodes over its
    block of the seeded self cache, split by positions as ``seq_decode_form``
    splits it, its cross-attention on its heads over the whole gathered
    memory. Every rank's output against the unsplit block fed the whole
    memory (within ``tol`` of its largest; ranks bit-equal), each gathered
    memory bit-equal to the whole one, each rank's cache block against
    those positions of the unsplit cache; ``unsplit32``: the fp32 unsplit
    outputs, read in bf16. Decode takes the plain path: no kernel launches."""
    L, n, T = cache["self"][0]["k"].shape[1], len(steps_in), memory.shape[1]
    start = L - L // W - n // 2

    def decode(block, layer, c):
        if layer is None:
            return torch.stack([block.decode(x, start + t, c["self"][0], memory)
                                for t, x in enumerate(steps_in)]), None
        axis = layer.axis
        split = axis.on("enc_blocks").seq
        own = memory[:, split.lo:split.hi].clone()  # the rank's frames
        axis.comm = CountingComm(axis.comm, own.shape)
        outs, exact = [], True
        for t, x in enumerate(steps_in):
            whole = axis.memory_in(own)
            exact = exact and torch.equal(whole, memory)
            outs.append(block.decode(x, start + t, c["self"][0], whole, axis=layer))
        return torch.stack(outs), {"frames": [split.lo, split.hi], "gathers": axis.comm.n,
                                   "gathered_exact": exact, "positions": layer.seq}

    t0 = time.perf_counter()
    with torch.no_grad():
        want_cache = copy.deepcopy(cache)
        want, _ = decode(model.dec_blocks[0], None, want_cache)
        torch.cuda.synchronize()
        reset_counts()
        got, caches = tp.thread_shares(model, "dec_blocks", 0, W, cache, decode,
                                       seq_len={"enc_blocks": T})
        torch.cuda.synchronize()
    launches = counts()
    info = [i for _, i in got]
    got = [out for out, _ in got]
    unsplit32.setdefault(W, want.float())
    cache_err = max(rel_err(c["self"][0][k], want_cache["self"][0][k][:, i["positions"].lo:
                                                                      i["positions"].hi])
                    for c, i in zip(caches, info) for k in ("k", "v"))
    rec = {"case": case, "form": "memory split along model (Shard(1)), gathered once a step; "
                                 "ranks run together (threads)",
           "model_ranks": W, "dtype": str(dtype)[6:], "batch": int(steps_in[0].shape[0]),
           "memory_frames": T, "rank_frames": [i["frames"] for i in info], "cache_len": L,
           "start": start, "steps": n, "memory_gathers": [i["gathers"] for i in info],
           "gathered_memory_exact": all(i["gathered_exact"] for i in info),
           "ranks_equal": all(torch.equal(o, got[0]) for o in got),
           "rel_err_per_step": [rel_err(a, b) for a, b in zip(got[0], want)],
           "cache_rel_err": cache_err, "tol": tol, "launches": launches,
           "seconds": time.perf_counter() - t0}
    rec["rel_err"] = max(rec["rel_err_per_step"])
    if dtype == torch.bfloat16:
        rec["unsplit_vs_fp32"] = rel_err(want, unsplit32[W])
        rec["shares_vs_fp32"] = rel_err(got[0], unsplit32[W])
    print("whisper_serve_split_memory", json.dumps(rec), flush=True)
    need(all(f[1] - f[0] == T // W for f in rec["rank_frames"]) and T % W == 0,
         f"{case} at {W}: the memory does not split by frames: {rec['rank_frames']}")
    need(rec["memory_gathers"] == [n] * W and rec["gathered_memory_exact"],
         f"{case} at {W}: memory gathers {rec['memory_gathers']} in {n} steps, exact "
         f"{rec['gathered_memory_exact']}")
    need(launches == launch_counts(), f"{case} split memory at {W}: launches {launches}")
    need(rec["ranks_equal"] and bool(torch.isfinite(got[0].float()).all())
         and rec["rel_err"] <= tol and cache_err <= tol,
         f"{case} split memory at {W} ({dtype}): {rec['rel_err']}, cache {cache_err}, ranks "
         f"equal {rec['ranks_equal']}")
    return rec


def whisper_serve_replay(model, params, frames, first, fed, full,
                         steps=WHISPER_DECODE_STEPS):
    """An encode of ``frames`` (cold, then warm), then one decode step from
    ``first`` and one on each of the first ``steps`` columns of ``fed``
    (None: greedy, each step's argmax): the memory, every call's logits in
    fp32 [1 + steps, B, 1, V], the tokens fed, encode ms, decode wall and
    device ms a step, launches."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    encode_ms = []
    with torch.no_grad():
        for _ in range(2):
            cache = model.init_cache(frames.shape[0], WHISPER_S, torch.bfloat16)
            reset_counts()
            start.record()
            memory, cache = model.prefill(params, {"frames": frames}, cache)
            end.record()
            torch.cuda.synchronize()
            encode_ms.append(start.elapsed_time(end))
            encode_launches = counts()
        tok, out, toks = first, [], []
        reset_counts()
        t0 = time.perf_counter()
        start.record()
        for i in range(steps + 1):
            logits, cache = model.decode_step(params, cache, tok, memory)
            out.append(full(logits).float())
            if i < steps:
                tok = out[-1].argmax(-1) if fed is None else fed[:, i:i + 1]
                toks.append(tok)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = steps + 1
    return {"memory": full(memory), "logits": torch.stack(out), "tokens": torch.cat(toks, 1),
            "encode_ms": encode_ms, "encode_launches": encode_launches,
            "decode_launches": counts(), "decode_ms_per_step": wall * 1e3 / n,
            "decode_device_ms_per_step": start.elapsed_time(end) / n, "pos": cache["pos"]}


def whisper_serve_path():
    """(b) whisper-medium at full width (24 + 24 layers, bf16, seeded
    weights), B 4 x 1500 frames: the encode and 65 decode calls (from the
    start token, then 64 greedy) unsharded; then the same weights sharded in
    place on a 1-rank NCCL mesh under ``fsdp_tp``, ``ShardedModel.prefill``
    and 65 ``decode_step`` calls fed the unsharded run's tokens (each decoder
    block's self-attention over its cache's one sequence shard, which holds
    every position: the plain path, as one process's). The memory and each
    call's logits against the
    unsharded ones (within 1e-3 of the largest; bit-equality printed), the
    sharded argmax against the unsharded tokens (each flip reported with the
    unsharded top-2 margin there), 24 tensor-core flash launches an encode
    and none a decode step on both sides, encode and decode ms of both.
    Then the same mesh under ``serve_2d``'s rules (its weights' ``embed``
    blocks stay, one rank's whole dims here): the encode and
    ``WHISPER_SERVE_2D_STEPS`` + 1 greedy decode calls, whose tokens equal
    the ``fsdp_tp`` path's."""
    cfg = whisper_cfg()
    model = build_model(cfg)
    params = model.init(SEED, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    frames = torch.randn(WHISPER_B, WHISPER_T, cfg.d_model, generator=g,
                         device="cuda").bfloat16()
    first = torch.full((WHISPER_B, 1), WHISPER_START, device="cuda")
    plain = whisper_serve_replay(model, params, frames, first, None, lambda t: t)
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        sharded_model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES["fsdp_tp"]())
        sharded_model.shard(params)  # in place: each weight a DTensor over the one rank
        cache = sharded_model.init_cache(WHISPER_B, WHISPER_S, torch.bfloat16)
        layer = sharded_model.model_axis(params, cache, (), WHISPER_B).layer(0, "dec_blocks")
        sharded = whisper_serve_replay(sharded_model, params, frames, first, plain["tokens"],
                                       lambda t: t.full_tensor())
        serve_model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES["serve_2d"]())
        serve_layer = serve_model.model_axis(params, cache, (), WHISPER_B,
                                             stationary=True).layer(0, "dec_blocks")
        serve_2d = whisper_serve_replay(serve_model, params, frames, first, None,
                                        lambda t: t.full_tensor(), WHISPER_SERVE_2D_STEPS)
    del params, cache
    torch.cuda.empty_cache()
    want, got = plain["logits"], sharded["logits"]
    want_toks = plain["tokens"].cpu()
    got_toks = got[:-1, :, 0].argmax(-1).T.cpu()
    top2 = want[:-1, :, 0].topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).T.cpu()
    diff = (got - want).abs().amax(dim=(1, 2, 3)).cpu()
    flips = [{"row": r, "step": i, "margin": float(margin[r, i]), "max_abs_dlogit": float(diff[i])}
             for r, i in torch.nonzero(got_toks != want_toks).tolist()]
    per_encode = launch_counts(flash_wgmma=cfg.n_encoder_layers)
    rec = {"arch": cfg.name, "layers": [cfg.n_encoder_layers, cfg.n_layers], "dtype": "bfloat16",
           "mesh": {"data": 1, "model": 1}, "strategy": "fsdp_tp", "batch": WHISPER_B,
           "frames": WHISPER_T, "cache_len": WHISPER_S, "decode_calls": len(want),
           "cache_seq_split": None if layer.seq is None else list(layer.seq),
           "memory_rel_err": rel_err(sharded["memory"], plain["memory"]),
           "memory_bit_equal": bool(torch.equal(sharded["memory"], plain["memory"])),
           "logits_rel_err": [rel_err(a, b) for a, b in zip(got, want)],
           "logits_bit_equal": bool(torch.equal(got, want)),
           "logits_max_abs": float(want.abs().max()), "tol": WHISPER_SERVE_PATH_TOL,
           "tokens_equal": int((got_toks == want_toks).sum()), "tokens": want_toks.numel(),
           "flips": flips, "first_tokens": want_toks[:, :8].tolist(),
           "encode_ms": {"unsharded": plain["encode_ms"], "sharded": sharded["encode_ms"]},
           "decode_ms_per_step": {"unsharded": plain["decode_ms_per_step"],
                                  "sharded": sharded["decode_ms_per_step"]},
           "decode_device_ms_per_step": {"unsharded": plain["decode_device_ms_per_step"],
                                         "sharded": sharded["decode_device_ms_per_step"]},
           "launches_per_encode": {"unsharded": plain["encode_launches"],
                                   "sharded": sharded["encode_launches"]},
           "launches_decode": {"unsharded": plain["decode_launches"],
                               "sharded": sharded["decode_launches"]}}
    n = WHISPER_SERVE_2D_STEPS
    serve_toks = serve_2d["tokens"].cpu()
    rec["serve_2d"] = {
        "strategy": "serve_2d", "decode_calls": n + 1,
        "cache_seq_split": None if serve_layer.seq is None else list(serve_layer.seq),
        "memory_bit_equal_fsdp_tp": bool(torch.equal(serve_2d["memory"], sharded["memory"])),
        "tokens_equal_fsdp_tp": bool(torch.equal(serve_toks, got_toks[:, :n])),
        "first_tokens": serve_toks[:, :8].tolist(),
        "logits_rel_err_fsdp_tp": max(rel_err(a, b) for a, b in zip(serve_2d["logits"], got)),
        "encode_ms": serve_2d["encode_ms"], "decode_ms_per_step": serve_2d["decode_ms_per_step"],
        "decode_device_ms_per_step": serve_2d["decode_device_ms_per_step"],
        "launches_per_encode": serve_2d["encode_launches"],
        "launches_decode": serve_2d["decode_launches"]}
    print("whisper_serve_path", json.dumps(rec), flush=True)
    for side, steps in ((plain, WHISPER_DECODE_STEPS), (sharded, WHISPER_DECODE_STEPS),
                        (serve_2d, n)):
        need(side["encode_launches"] == per_encode and side["decode_launches"] == launch_counts(),
             f"whisper serve path launches {side['encode_launches']}, {side['decode_launches']}")
        need(side["pos"] == steps + 1, f"whisper serve path pos {side['pos']}")
    need(rec["serve_2d"]["tokens_equal_fsdp_tp"],
         f"whisper serve path: serve_2d's tokens {serve_toks[:, :8].tolist()} differ from "
         f"fsdp_tp's {got_toks[:, :8].tolist()}")
    need(bool(torch.isfinite(serve_2d["logits"]).all()), "whisper serve_2d path: non-finite")
    need(layer.seq is not None, "whisper serve path: the self cache's sequence does not lie "
                                "over model")
    need(bool(torch.isfinite(got).all()) and bool(torch.isfinite(sharded["memory"]).all()),
         "whisper serve path: non-finite memory or logits")
    need(rec["memory_rel_err"] <= WHISPER_SERVE_PATH_TOL
         and max(rec["logits_rel_err"]) <= WHISPER_SERVE_PATH_TOL,
         f"whisper serve path: memory {rec['memory_rel_err']}, logits "
         f"{max(rec['logits_rel_err'])}")
    need(not flips, f"whisper serve path: greedy tokens differ: {flips}")
    return rec


def whisper_encode_seq_shares():
    """(a) The sharded encode's blocks in the sequence form, forward only
    under ``no_grad``: one full-width encoder block, B 4 x T frames, fp32
    then the same weights in bf16: the unsplit ``EncBlock``, then for each
    (W, T) of ``WHISPER_ENCODE_SEQ_SETTINGS`` every rank's share in turn
    (``tensor_parallel.share(..., seq_len={"enc_blocks": T})`` and
    ``block_shares``: each rank normalizes its own positions, the normed
    blocks concatenated are every rank's gathered input, the split parts'
    terms added in fp32 and sliced to each rank's positions, as the encode's
    gathers and reduce-scatters give them); where the axis does not divide
    T (1500 frames at 16 ranks) the stream stays whole, the plain form. The
    ranks' blocks side by side against the unsplit block's output, fp32
    within 1e-5 of its largest, bf16 within 5e-2 beside the unsplit bf16
    block's own error; W flash launches (one a rank, on its heads over the
    gathered frames), one for the unsplit block."""
    cfg = whisper_cfg(1)
    model = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    inputs = {T: torch.randn(WHISPER_B, T, cfg.d_model, generator=g, device="cuda")
              for T in dict.fromkeys(t for _, t in WHISPER_ENCODE_SEQ_SETTINGS)}
    recs, unsplit32 = [], {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            model.to(dtype)
            kernel = {"wgmma": "flash_wgmma",
                      "simt": "flash"}[fa_ops.kernel_for(dtype, cfg.head_dim)]
            tol = WHISPER_TP_FP32_TOL if dtype == torch.float32 else WHISPER_TP_BF16_TOL
            for T, x32 in inputs.items():
                x, positions = x32.to(dtype), torch.arange(T, device="cuda")
                reset_counts()
                want = model.enc_blocks[0](x, positions)
                torch.cuda.synchronize()
                want_launches = counts()
                unsplit32.setdefault(T, want.float())
                for W in (w for w, t in WHISPER_ENCODE_SEQ_SETTINGS if t == T):
                    shares = [tp.share(model, None, r, W, seq_len={"enc_blocks": T})
                              for r in range(W)]
                    splits = [axis.on("enc_blocks").seq for axis, _, _ in shares]
                    reset_counts()
                    got = tp.block_shares(model, "enc_blocks", 0, shares, x, positions)
                    torch.cuda.synchronize()
                    launches = counts()
                    view = shares[0][0].layer(0, "enc_blocks")
                    rec = {"case": f"{cfg.name} enc_blocks.0 encode ({cfg.n_heads} heads, "
                                   f"d_ff {cfg.d_ff}), forward under no_grad",
                           "model_ranks": W, "dtype": str(dtype)[6:], "rows": [WHISPER_B, T],
                           "form": "sequence" if splits[0] is not None else "plain",
                           "rank_positions": [None if sp is None else [sp.lo, sp.hi]
                                              for sp in splits],
                           "rank_heads": cfg.n_heads // W, "rank_d_ff": cfg.d_ff // W,
                           "terms_added_in": "float32", "rel_err": rel_err(got, want),
                           "tol": tol, "launches_shares": launches,
                           "launches_unsplit": want_launches}
                    if dtype == torch.bfloat16:
                        rec["unsplit_vs_fp32"] = rel_err(want, unsplit32[T])
                        rec["shares_vs_fp32"] = rel_err(got, unsplit32[T])
                    print("whisper_serve_encode_seq_shares", json.dumps(rec), flush=True)
                    need(all((sp is not None) == (T % W == 0) for sp in splits)
                         and view.attn_sum and view.mlp_sum,
                         f"whisper encode at {W} over {T} frames: stream split {splits}, "
                         f"sums {view.attn_sum} {view.mlp_sum}")
                    need(want_launches == launch_counts(**{kernel: 1})
                         and launches == launch_counts(**{kernel: W}),
                         f"whisper encode shares at {W} over {T} ({dtype}): launches "
                         f"{launches}, unsplit {want_launches}")
                    need(bool(torch.isfinite(got.float()).all()) and rec["rel_err"] <= tol,
                         f"whisper encode shares at {W} over {T} ({dtype}): {rec['rel_err']}")
                    recs.append(rec)
                    del shares, got
                del want
    del model, inputs
    torch.cuda.empty_cache()
    return recs


# the weights of one encoder and one decoder block whose embed block stays
# under serve_2d, and the two that are gathered over data
WHISPER_GRID_KEPT = ("enc_blocks.0.attn.wq", "enc_blocks.0.attn.wk", "enc_blocks.0.attn.wv",
                     "enc_blocks.0.attn.wo", "enc_blocks.0.mlp.w_up", "enc_blocks.0.mlp.w_down",
                     "dec_blocks.0.attn.wq", "dec_blocks.0.attn.wk", "dec_blocks.0.attn.wv",
                     "dec_blocks.0.attn.wo", "dec_blocks.0.xattn.wq", "dec_blocks.0.xattn.wo",
                     "dec_blocks.0.mlp.w_up", "dec_blocks.0.mlp.w_down", "embed")
WHISPER_GRID_MOVED = ("dec_blocks.0.xattn.wk", "dec_blocks.0.xattn.wv")


def whisper_grid_shares(grids):
    """(d) one full-width encoder block and one decoder block with the
    embedding and the tied head, fp32 then the same weights in bf16, under
    ``serve_2d`` on each grid of ``grids``: every rank at once, a thread a
    rank (``tensor_parallel.thread_shares`` on the whole model), each
    computing from its weights' (embed block x model block): the encode of
    B 1 x 1500 frames (an encode share: no cache, ``rows=1``); then, fed its
    own memory, ``WHISPER_GRID_STEPS`` steps of the lookup, the decoder
    block's decode over its block of a seeded 448-slot self cache
    (positions split over (data, model)) and the tied head. Every rank's
    memory and streams against the unsplit model's (ranks bit-equal), its
    logits block against the unsplit logits, the ranks' cache blocks side
    by side against the unsplit cache; which weights keep their embed
    block; one flash launch a rank an encode (on its heads), none in
    decode (the plain path)."""
    cfg = whisper_cfg(1)
    model = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    api = build_model(cfg)
    rules = shd.STRATEGIES["serve_2d"]()
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    frames32 = torch.randn(1, WHISPER_T, cfg.d_model, generator=g, device="cuda")
    fed = [torch.randint(0, cfg.vocab_size, (1, 1), generator=g, device="cuda")
           for _ in range(WHISPER_GRID_STEPS)]

    def encode(frames):
        return lambda m, axis, _: (m.encode(frames, model_axis=axis), axis)

    def decode(memories):
        def run(m, axis, c):
            if axis is None:
                memory = memories[0]
            else:  # the rank's own memory, rank d M + m
                coord = axis.coord
                memory = axis.memory_in(memories[coord["data"] * axis.sizes["model"]
                                                 + coord["model"]])
            layer = None if axis is None else axis.layer(0, "dec_blocks")
            outs = []
            for t, tok in enumerate(fed):
                pos = WHISPER_GRID_START + t
                x = m._embed(tok, axis) + m.dec_pos[pos]
                h = m.dec_blocks[0].decode(x, pos, c["self"][0], memory, layer)
                outs.append((x, h, m._logits(h, axis)))
            return {k: torch.stack([o[i] for o in outs])
                    for i, k in enumerate(("embed", "block", "logits"))}, axis
        return run

    recs, unsplit32 = [], {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            model.to(dtype)
            frames = frames32.to(dtype)
            kernel = {"wgmma": "flash_wgmma", "simt": "flash"}[
                fa_ops.kernel_for(dtype, cfg.head_dim)]
            tol = TP_FP32_TOL if dtype == torch.float32 else TP_BF16_TOL
            reset_counts()
            want_memory = encode(frames)(model, None, None)[0]
            torch.cuda.synchronize()
            want_launches = counts()
            want_cache = seeded_cache(api, 1, WHISPER_S, dtype, SEED + 9)
            want = decode([want_memory])(model, None, want_cache)[0]
            want["memory"] = want_memory
            for grid in grids:
                t0 = time.perf_counter()
                M, n_ranks = grid["model"], grid["data"] * grid["model"]
                torch.cuda.synchronize()
                reset_counts()
                encoded, _ = tp.thread_shares(model, None, 0, grid, None, encode(frames), rules,
                                              rows=1)
                torch.cuda.synchronize()
                launches = {"encode": counts()}
                reset_counts()
                stepped, caches = tp.thread_shares(
                    model, None, 0, grid, seeded_cache(api, 1, WHISPER_S, dtype, SEED + 9),
                    decode([mem for mem, _ in encoded]), rules)
                torch.cuda.synchronize()
                launches["decode"] = counts()
                outs = [{**o, "memory": mem} for (o, _), (mem, _) in zip(stepped, encoded)]
                axes = [a for _, a in stepped] + [a for _, a in encoded]
                head = axes[0].head
                joined = {**outs[0], "logits": outs[0]["logits"] if head is None else torch.cat(
                    [o["logits"] for o in outs[:M]], -1)}
                kept = [name for name in WHISPER_GRID_KEPT + WHISPER_GRID_MOVED
                        if all(a.stationary(name) is not None for a in axes)]
                rec = {"case": f"{cfg.name} enc_blocks.0 + dec_blocks.0 ({cfg.n_heads} heads, "
                               f"d_ff {cfg.d_ff}), embedding and {cfg.vocab_size}-way tied head",
                       "strategy": "serve_2d", "grid": grid, "dtype": str(dtype)[6:], "B": 1,
                       "frames": WHISPER_T, "cache_len": WHISPER_S, "start": WHISPER_GRID_START,
                       "steps": WHISPER_GRID_STEPS,
                       "rank_embed_cols": cfg.d_model // grid["data"],
                       "head_split": None if head is None else [head.lo, head.hi],
                       "kept": kept, "rel_err": {}, "tol": tol,
                       "ranks_equal": all(torch.equal(o[k], outs[0][k]) for o in outs
                                          for k in ("memory", "embed", "block")),
                       "launches": launches, "launches_unsplit_encode": want_launches}
                for k, v in joined.items():
                    rec["rel_err"][k] = rel_err(v, want[k])
                    key = (str(grid), k)
                    if dtype == torch.float32:
                        unsplit32[key] = want[k].float()
                    else:
                        rec.setdefault("unsplit_vs_fp32", {})[k] = rel_err(want[k], unsplit32[key])
                        rec.setdefault("shares_vs_fp32", {})[k] = rel_err(v, unsplit32[key])
                rec["cache_rel_err"] = max(
                    rel_err(torch.cat([c["self"][0][k] for c in caches], 1),
                            want_cache["self"][0][k]) for k in ("k", "v"))
                rec["seconds"] = time.perf_counter() - t0
                print("whisper_serve_grid_shares", json.dumps(rec), flush=True)
                need(kept == list(WHISPER_GRID_KEPT),
                     f"whisper grid {grid}: the blocks that stay are {kept}")
                need(want_launches == launch_counts(**{kernel: 1})
                     and launches == {"encode": launch_counts(**{kernel: n_ranks}),
                                      "decode": launch_counts()},
                     f"whisper grid {grid} ({dtype}): launches {launches}, unsplit "
                     f"{want_launches}")
                need(rec["ranks_equal"], f"whisper grid {grid} ({dtype}): the ranks differ")
                need(all(torch.isfinite(o[k].float()).all() for o in outs for k in o),
                     f"whisper grid {grid} ({dtype}): non-finite")
                need(max(rec["rel_err"].values()) <= tol and rec["cache_rel_err"] <= tol,
                     f"whisper grid {grid} ({dtype}): {rec['rel_err']}, cache "
                     f"{rec['cache_rel_err']}")
                recs.append(rec)
                del encoded, stepped, caches, outs
    del model
    torch.cuda.empty_cache()
    return recs


def whisper_tp_serve_phase():
    out, seconds = {}, {}
    for name, fn in (("shares", lambda: whisper_serve_shares(WHISPER_TP_RANKS)),
                     ("encode_seq_shares", whisper_encode_seq_shares),
                     ("path", whisper_serve_path),
                     ("grid_shares", lambda: whisper_grid_shares(TP_GRIDS))):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
    print("whisper_tp_serve_seconds", json.dumps(seconds), flush=True)
    return {**out, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phases 8e-8f: internvl2-76b, the vision prefix
# ---------------------------------------------------------------------------

# B 4, one image tile (the stub frontend's 256 rows) before 2304-token prompts,
# a 4096-slot cache, 16 greedy steps; 24 of 80 layers (42.2 GiB of bf16
# weights; all 80 are 131 GiB)
VLM_LAYERS, VLM_B, VLM_P, VLM_S, VLM_MAX_LEN, VLM_STEPS = 24, 4, 256, 2304, 4096, 16


def vlm_cfg(n_layers):
    """internvl2-76b at full width, depth cut to ``n_layers``."""
    cfg = get_config("internvl2-76b")
    need((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
          cfg.vocab_size, cfg.frontend, cfg.frontend_seq_len)
         == (80, 8192, 64, 8, 128, 28672, 128256, "vision", VLM_P), "internvl2-76b width")
    return dataclasses.replace(cfg, n_layers=n_layers)


def vlm_serve_phase(flash_rec):
    """internvl2-76b (24 layers, bf16) through the model API with a seeded
    prefix: a prefill cold then warm under CUDA events (the warm one with each
    flash call's span), exactly 24 tensor-core flash launches a prefill, then
    16 greedy decode steps with none. ``flash_rec``: the kernel phase's
    internvl2-shape record, whose time x 24 is set beside the flash spans."""
    cfg = vlm_cfg(VLM_LAYERS)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    prefix = torch.randn(VLM_B, VLM_P, cfg.d_model, generator=g, device="cuda").bfloat16()
    tokens = torch.randint(0, cfg.vocab_size, (VLM_B, VLM_S), generator=g, device="cuda")
    batch = {"tokens": tokens, "prefix_embeds": prefix}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    prefill_ms, per_prefill = [], []
    with torch.inference_mode():
        for _ in range(2):  # cold, then warm
            cache = model.init_cache(VLM_B, VLM_MAX_LEN, torch.bfloat16)
            reset_counts()
            with StageEvents(fa_ops, ["attention"]) as flash_ev:
                start.record()
                logits, cache = model.prefill(params, batch, cache)
                end.record()
                flash_ms = flash_ev.ms()["attention"]
            prefill_ms.append(start.elapsed_time(end))
            per_prefill.append(counts())
        for launches in per_prefill:
            need(launches == launch_counts(flash_wgmma=VLM_LAYERS),
                 f"vlm prefill launches {launches}")
        need(logits.shape == (VLM_B, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
             "vlm prefill logits: shape or non-finite values")
        need(cache["pos"] == VLM_P + VLM_S, f"vlm prefill pos {cache['pos']}")
        reset_counts()
        tok, out = logits.argmax(-1), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(VLM_STEPS):
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits.argmax(-1)
            out.append(tok)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    decode_launches = counts()
    need(decode_launches == launch_counts(), f"vlm decode launched {decode_launches}")
    toks = torch.cat(out, dim=1).cpu()
    need(toks.shape == (VLM_B, VLM_STEPS) and cache["pos"] == VLM_P + VLM_S + VLM_STEPS
         and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
         and bool(torch.isfinite(logits).all()), "vlm decode tokens")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": sum(p.numel() for p in params.parameters()), "dtype": "bfloat16",
           "batch": VLM_B, "prefix_rows": VLM_P, "prompt_len": VLM_S, "max_len": VLM_MAX_LEN,
           "prefill_ms_cold": prefill_ms[0], "prefill_ms": prefill_ms[1],
           "prefill_tok_per_s": VLM_B * (VLM_P + VLM_S) / (prefill_ms[1] * 1e-3),
           "prefill_flash_ms": flash_ms, "prefill_flash_share": flash_ms / prefill_ms[1],
           "flash_kernel_ms_x_layers": flash_rec["ms"] * cfg.n_layers,
           "decode_steps": VLM_STEPS, "decode_ms_per_step": wall * 1e3 / VLM_STEPS,
           "decode_device_ms_per_step": start.elapsed_time(end) / VLM_STEPS,
           "tok_per_s": VLM_B * VLM_STEPS / wall, "first_tokens": toks[:, :8].tolist(),
           "launches_per_prefill": per_prefill[-1], "launches_decode": decode_launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("vlm_serve", json.dumps(rec), flush=True)
    return rec, {"cfg": cfg, "params": params, "batch": batch, "tokens": toks}


def vlm_check_phase(tol, loss_tol, grad_tol):
    """Full width, fp32 (the CUDA-core flash kernel), card against CPU:
    (a) 2 layers, B 1: prefill over the 256-row prefix and 64 tokens, then 8
    decode steps fed the same tokens -- logits within ``tol``, the same argmax;
    (b) 1 layer (2.96B parameters): ``lm_loss`` with the prefix over 64
    tokens under remat "nothing", the loss within ``loss_tol`` and every
    gradient within ``grad_tol`` of its leaf's largest."""
    rng = np.random.default_rng(SEED)
    cfg = vlm_cfg(2)
    prefix = rng.standard_normal((1, VLM_P, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (1, 72))
    lm = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)

    def run(lm, dev):
        model = build_model(cfg, device=dev)
        marks = [counts()]
        with torch.inference_mode():
            cache = model.init_cache(1, 512, torch.float32)
            out, cache = model.prefill(lm, {"tokens": torch.from_numpy(toks[:, :64]).to(dev),
                                            "prefix_embeds": torch.from_numpy(prefix).to(dev)},
                                       cache)
            marks.append(counts())
            outs = [out.float().cpu()]
            for t in range(64, 72):
                out, cache = model.decode_step(lm, cache, torch.from_numpy(toks[:, t:t + 1]).to(dev))
                outs.append(out.float().cpu())
            marks.append(counts())
        launches = [{k: b[k] - a[k] for k in a} for a, b in zip(marks, marks[1:])]
        return torch.cat(outs, dim=1), launches, cache["pos"]

    reset_counts()
    on_card, launches, pos = run(lm, torch.device("cuda"))
    need(launches == [launch_counts(flash=2), launch_counts()], f"vlm check launches {launches}")
    cpu_lm = LM(cfg, torch.device("cpu"), torch.float32)
    cpu_lm.load_state_dict(lm.state_dict())
    del lm
    torch.cuda.empty_cache()
    on_cpu, _, cpu_pos = run(cpu_lm, torch.device("cpu"))
    del cpu_lm
    err = float((on_card - on_cpu).abs().max())
    rec = {"arch": cfg.name, "layers": 2, "dtype": "float32", "prefix_rows": VLM_P,
           "prompt_len": 64, "decode_steps": 8, "pos": [pos, cpu_pos],
           "max_abs_logit": float(on_cpu.abs().max()), "max_abs_err": err, "tol": tol,
           "argmax_equal": bool(torch.equal(on_card.argmax(-1), on_cpu.argmax(-1))),
           "launches": dict(zip(("prefill", "decode"), launches))}
    need(pos == cpu_pos == VLM_P + 72, f"vlm check pos {pos}, {cpu_pos}")
    need(torch.isfinite(on_card).all(), "vlm check: non-finite logits on the card")
    need(err <= tol, f"vlm check: card vs CPU logits differ by {err} > {tol}")
    need(rec["argmax_equal"], "vlm check: card and CPU pick different tokens")

    cfg = vlm_cfg(1)
    lm = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 64)),
             "labels": rng.integers(0, cfg.vocab_size, (1, 64)),
             "prefix_embeds": rng.standard_normal((1, VLM_P, cfg.d_model)).astype(np.float32)}

    def loss_and_grads(lm, dev):
        lm.requires_grad_(True)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, _ = lm_loss(lm, tb)
        names, ps = zip(*lm.named_parameters())
        grads = torch.autograd.grad(loss, ps)
        return float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)}

    reset_counts()
    loss, grads = loss_and_grads(lm, torch.device("cuda"))
    torch.cuda.synchronize()
    loss_launches = counts()
    # remat "nothing": flash in the forward and again in the layer's recompute
    need(loss_launches == launch_counts(flash=2), f"vlm loss launches {loss_launches}")
    cpu_lm = LM(cfg, torch.device("cpu"), torch.float32)
    cpu_lm.load_state_dict(lm.state_dict())
    n_params = sum(p.numel() for p in lm.parameters())
    del lm
    torch.cuda.empty_cache()
    cpu_loss, cpu_grads = loss_and_grads(cpu_lm, torch.device("cpu"))
    del cpu_lm
    rel = {n: float((grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
           for n, g in cpu_grads.items()}
    worst = max(rel, key=rel.get)
    rec["loss_check"] = {"layers": 1, "params": n_params, "tokens": 64, "loss": loss,
                         "cpu_loss": cpu_loss, "loss_abs_err": abs(loss - cpu_loss),
                         "loss_tol": loss_tol, "worst_leaf": worst,
                         "worst_leaf_rel_err": rel[worst],
                         "grad_tol": f"{grad_tol} * max|g| per leaf", "leaves": len(rel),
                         "launches": loss_launches}
    print("vlm_check", json.dumps(rec), flush=True)
    need(np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
         "vlm loss check: non-finite loss or gradient")
    need(abs(loss - cpu_loss) <= loss_tol, f"vlm: card vs CPU loss {loss} vs {cpu_loss}")
    need(rel[worst] <= grad_tol, f"vlm: gradient of {worst} off by {rel[worst]}")
    return rec


# ---------------------------------------------------------------------------
# Phase 8g: tensor-parallel serving on the model axis
# ---------------------------------------------------------------------------

TP_S, TP_HEAD_ROWS = 2560, 64
TP_FP32_TOL, TP_BF16_TOL = 1e-4, 5e-2


def rel_err(got, want):
    """max |got - want| over max |want|, in fp32."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def tp_path(state, vlm, strategies=("fsdp_tp", "serve_2d")):
    """(c) phase 8e's weights sharded in place on a 1-rank NCCL mesh, through
    ``ShardedModel`` under each of ``strategies``' rules: a prefill cold then
    warm, 16 greedy steps. -> the records by strategy."""
    cfg, params, batch = state["cfg"], state["params"], state["batch"]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    recs = {}
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        # in place: each weight a DTensor over the one rank, its whole tensor
        ShardedModel(build_model(cfg), mesh, shd.STRATEGIES[strategies[0]]()).shard(params)
        for strategy in strategies:
            model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES[strategy]())
            prefill_ms = []
            with torch.no_grad():
                for _ in range(2):  # cold, then warm
                    cache = model.init_cache(VLM_B, VLM_MAX_LEN, torch.bfloat16)
                    reset_counts()
                    start.record()
                    logits, cache = model.prefill(params, batch, cache)
                    end.record()
                    torch.cuda.synchronize()
                    prefill_ms.append(start.elapsed_time(end))
                    prefill_launches = counts()
                placements = [str(p) for p in logits.placements]
                reset_counts()
                tok, out = logits.full_tensor().argmax(-1), []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                for _ in range(VLM_STEPS):
                    logits, cache = model.decode_step(params, cache, tok)
                    tok = logits.full_tensor().argmax(-1)
                    out.append(tok)
                end.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            decode_launches = counts()
            pos = cache["pos"]
            toks = torch.cat(out, dim=1).cpu()
            rec = {"mesh": {"data": 1, "model": 1}, "strategy": strategy,
                   "layers": cfg.n_layers, "batch": VLM_B, "prefix_rows": VLM_P,
                   "prompt_len": VLM_S, "prefill_ms_cold": prefill_ms[0],
                   "prefill_ms": prefill_ms[1], "vlm_serve_prefill_ms": vlm["prefill_ms"],
                   "decode_ms_per_step": wall * 1e3 / VLM_STEPS,
                   "decode_device_ms_per_step": start.elapsed_time(end) / VLM_STEPS,
                   "vlm_serve_decode_ms_per_step": vlm["decode_ms_per_step"],
                   "logits_placements": placements,
                   "tokens_equal": bool(torch.equal(toks, state["tokens"])),
                   "launches_per_prefill": prefill_launches, "launches_decode": decode_launches}
            if strategy != strategies[0]:
                rec[f"{strategies[0]}_decode_ms_per_step"] = recs[strategies[0]][
                    "decode_ms_per_step"]
            print("tp_serve_path", json.dumps(rec), flush=True)
            need(prefill_launches == launch_counts(flash_wgmma=VLM_LAYERS),
                 f"tp prefill launches {prefill_launches} ({strategy})")
            need(decode_launches == launch_counts(),
                 f"tp decode launched {decode_launches} ({strategy})")
            need(pos == VLM_P + VLM_S + VLM_STEPS, f"tp pos {pos} ({strategy})")
            need(rec["tokens_equal"], f"tp tokens {toks[:, :8].tolist()} ({strategy}) differ "
                                      f"from vlm_serve's {state['tokens'][:, :8].tolist()}")
            recs[strategy] = rec
    return recs


def rank_heads(layer, cfg):
    """(query heads, KV heads) of rank 0's flash call in a prefill."""
    if layer.kv is not None:
        return [layer.q.hi - layer.q.lo, layer.kv.hi - layer.kv.lo]
    kv = tp.kv_heads(layer.q.lo, layer.q.hi, cfg.n_heads, cfg.n_kv_heads)
    return [layer.q.hi - layer.q.lo, len(range(cfg.n_kv_heads)[kv]) if isinstance(kv, slice)
            else len(kv)]


def tp_shares(cfg, ranks, seq_recs):
    """(a) one full-width layer of ``cfg`` and its head, fp32 then the same
    weights in bf16: for each W in ``ranks`` every rank's share in turn, the
    sums over ``model`` applied here, against the unsplit layer. Then, into
    ``seq_recs``, the layer's decode at B 4 over a seeded 2560-slot cache
    split by positions (``seq_decode_form``: the ranks run together, their
    partial softmaxes merged)."""
    lm = init_params(dataclasses.replace(cfg, n_layers=1), seed=SEED, device="cuda",
                     dtype=torch.float32)
    model = build_model(lm.cfg)
    block = lm.layers[0]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x32 = torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, TP_S), generator=g, device="cuda")
    positions = torch.arange(TP_S, device="cuda")
    decode32 = [torch.randn(4, 1, cfg.d_model, generator=g, device="cuda")
                for _ in range(SEQ_DECODE_STEPS)]
    recs, unsplit32, seq32 = [], None, {}
    for dtype in (torch.float32, torch.bfloat16):
        lm.to(dtype)
        x = x32.to(dtype)
        with torch.no_grad():
            reset_counts()
            want = block.prefill(x, positions, model.init_cache(1, TP_S, dtype)["layers"][0])
            want_launches = counts()
            want = {"layer": want, "logits": lm._logits(want[:, -TP_HEAD_ROWS:]),
                    "embed": lm._embed(tokens)}
            if unsplit32 is None:
                unsplit32 = {k: v.float() for k, v in want.items()}
            for W in ranks:
                cache = model.init_cache(1, TP_S, dtype)
                shares = [tp.share(lm, cache, r, W) for r in range(W)]

                def each(fn):
                    out = []
                    for axis, params, rank_cache in shares:
                        with _reparametrize_module(lm, params):
                            out.append(fn(axis, rank_cache))
                    return out

                reset_counts()
                h = common.apply_norm(block.norm1, x)
                parts = each(lambda axis, c: block.attn.prefill(
                    h, positions, c["layers"][0], axis.layer(0)))
                launches = counts()
                layer = shares[0][0].layer(0)
                need(layer.attn_sum and layer.mlp_sum, f"{cfg.name} at {W}: no split")
                x1 = x + sum(parts)
                h = common.apply_norm(block.norm2, x1)
                x2 = x1 + sum(each(lambda axis, c: block.mlp(h)))
                logits = torch.cat(each(lambda axis, c: lm._logits(x2[:, -TP_HEAD_ROWS:])), -1)
                embed = sum(each(lambda axis, c: lm._embed(tokens, model_axis=axis)))
                got = {"layer": x2, "logits": logits, "embed": embed}
                rec = {"case": f"{cfg.name} layer ({cfg.n_heads}/{cfg.n_kv_heads} heads, "
                               f"{cfg.mlp_type}) and {cfg.vocab_size}-way head",
                       "model_ranks": W, "dtype": str(dtype)[6:], "B": 1, "S": TP_S,
                       "rank_heads": rank_heads(layer, cfg),
                       "rel_err": {k: rel_err(got[k], want[k]) for k in want},
                       "tol": TP_FP32_TOL if dtype == torch.float32 else TP_BF16_TOL,
                       "launches_shares": launches, "launches_unsplit": want_launches}
                if dtype == torch.bfloat16:
                    rec["unsplit_vs_fp32"] = {k: rel_err(want[k], unsplit32[k]) for k in want}
                    rec["shares_vs_fp32"] = {k: rel_err(got[k], unsplit32[k]) for k in want}
                print("tp_shares", json.dumps(rec), flush=True)
                kernel = {"wgmma": "flash_wgmma", "simt": "flash"}[
                    fa_ops.kernel_for(dtype, cfg.head_dim)]
                need(launches == launch_counts(**{kernel: W}),
                     f"tp shares {cfg.name} at {W} ({dtype}): launches {launches}")
                need(all(torch.isfinite(v.float()).all() for v in got.values()),
                     f"tp shares {cfg.name} at {W}: non-finite")
                need(max(rec["rel_err"].values()) <= rec["tol"],
                     f"tp shares {cfg.name} at {W} ({dtype}): {rec['rel_err']}")
                recs.append(rec)
                del shares, parts, got
                seq_recs.append(seq_decode_form(
                    f"{cfg.name} layer 0 decode ({cfg.n_heads}/{cfg.n_kv_heads} heads)", lm,
                    "layers", seeded_cache(model, 4, TP_S, dtype, SEED + 6),
                    [t.to(dtype) for t in decode32], (), W, dtype, rec["tol"], seq32))
    del lm
    torch.cuda.empty_cache()
    return recs


# serve_2d's (data x model) grids for one full-width internvl2-76b layer: 16 ranks each
TP_GRIDS = ({"data": 2, "model": 8}, {"data": 4, "model": 4})


def tp_grid_shares(cfg, grids):
    """(d) one full-width layer of ``cfg`` with its embedding and head, fp32
    then the same weights in bf16, under ``serve_2d`` on each grid of
    ``grids``: every rank at once, a thread a rank
    (``tensor_parallel.thread_shares`` on the whole LM), each computing from
    its weights' (embed block x model block): the lookup, the layer's
    prefill of B 1 x S 2560 into its block of the cache (positions split
    over (data, model)) and the head on the last rows; then, in a second
    run over the cache the ranks filled, one decode step. Every rank's
    stream against the unsplit one's, the logits' blocks laid side by side
    against the unsplit logits, the ranks' cache blocks against the
    unsplit cache; the launches of each run."""
    lm = init_params(dataclasses.replace(cfg, n_layers=1), seed=SEED, device="cuda",
                     dtype=torch.float32)
    model = build_model(lm.cfg)
    rules = shd.STRATEGIES["serve_2d"]()
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tokens = torch.randint(0, cfg.vocab_size, (1, TP_S), generator=g, device="cuda")
    fed = torch.randint(0, cfg.vocab_size, (1, 1), generator=g, device="cuda")
    positions = torch.arange(TP_S, device="cuda")
    length = TP_S + 16  # the step's slot past the prompt; 16 ranks divide it

    def prefill(m, axis, cache):
        layer = None if axis is None else axis.layer(0)
        x = m._embed(tokens, model_axis=axis)
        h = m.layers[0].prefill(x, positions, cache["layers"][0], layer)
        return {"embed": x, "layer": h, "logits": m._logits(h[:, -TP_HEAD_ROWS:], axis)}

    def decode(m, axis, cache):
        layer = None if axis is None else axis.layer(0)
        x = m._embed(fed, model_axis=axis)
        h = m.layers[0].decode(x, TP_S, cache["layers"][0], layer)
        return {"embed": x, "layer": h, "logits": m._logits(h, axis)}

    recs, unsplit32 = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        lm.to(dtype)
        with torch.no_grad():
            want_cache = model.init_cache(1, length, dtype)
            want = {"prefill": prefill(lm, None, want_cache),
                    "decode": decode(lm, None, want_cache)}
            for grid in grids:
                M = grid["model"]
                torch.cuda.synchronize()
                reset_counts()
                got, caches = tp.thread_shares(lm, None, 0, grid,
                                               model.init_cache(1, length, dtype), prefill,
                                               rules)
                torch.cuda.synchronize()
                launches = {"prefill": counts()}
                # the cache the ranks filled, whole: rank r holds chunk r of its positions
                filled = model.init_cache(1, length, dtype)
                for k in ("k", "v"):
                    filled["layers"][0][k].copy_(
                        torch.cat([c["layers"][0][k] for c in caches], 1))
                reset_counts()
                stepped, caches = tp.thread_shares(lm, None, 0, grid, filled, decode, rules)
                torch.cuda.synchronize()
                launches["decode"] = counts()
                stepped_cache = {k: torch.cat([c["layers"][0][k] for c in caches], 1)
                                 for k in ("k", "v")}
                rec = {"case": f"{cfg.name} layer ({cfg.n_heads}/{cfg.n_kv_heads} heads, "
                               f"{cfg.mlp_type}), embedding and {cfg.vocab_size}-way head",
                       "strategy": "serve_2d", "grid": grid, "dtype": str(dtype)[6:],
                       "B": 1, "S": TP_S, "cache_len": length, "rel_err": {},
                       "tol": TP_FP32_TOL if dtype == torch.float32 else TP_BF16_TOL,
                       "launches": launches}
                for when, outs in (("prefill", got), ("decode", stepped)):
                    joined = {"embed": outs[0]["embed"], "layer": outs[0]["layer"],
                              "logits": torch.cat([o["logits"] for o in outs[:M]], -1)}
                    rec["ranks_equal_" + when] = all(
                        torch.equal(o[k], outs[0][k]) for o in outs for k in ("embed", "layer"))
                    for k, v in joined.items():
                        rec["rel_err"][f"{when}_{k}"] = rel_err(v, want[when][k])
                        key = (grid["model"], when, k)
                        if dtype == torch.float32:
                            unsplit32[key] = (want[when][k].float(), v.float())
                        else:
                            rec.setdefault("unsplit_vs_fp32", {})[f"{when}_{k}"] = rel_err(
                                want[when][k], unsplit32[key][0])
                            rec.setdefault("shares_vs_fp32", {})[f"{when}_{k}"] = rel_err(
                                v, unsplit32[key][0])
                rec["cache_rel_err"] = max(rel_err(stepped_cache[k], want_cache["layers"][0][k])
                                           for k in ("k", "v"))
                print("tp_grid_shares", json.dumps(rec), flush=True)
                kernel = {"wgmma": "flash_wgmma", "simt": "flash"}[
                    fa_ops.kernel_for(dtype, cfg.head_dim)]
                n_ranks = grid["data"] * grid["model"]
                need(launches == {"prefill": launch_counts(**{kernel: n_ranks}),
                                  "decode": launch_counts()},
                     f"tp grid {grid} ({dtype}): launches {launches}")
                need(rec["ranks_equal_prefill"] and rec["ranks_equal_decode"],
                     f"tp grid {grid} ({dtype}): the ranks' streams differ")
                need(all(torch.isfinite(o[k].float()).all() for outs in (got, stepped)
                         for o in outs for k in o), f"tp grid {grid} ({dtype}): non-finite")
                need(max(rec["rel_err"].values()) <= rec["tol"]
                     and rec["cache_rel_err"] <= rec["tol"],
                     f"tp grid {grid} ({dtype}): {rec['rel_err']}, cache "
                     f"{rec['cache_rel_err']}")
                recs.append(rec)
                del got, stepped, caches, filled
    del lm
    torch.cuda.empty_cache()
    return recs


def tp_serve_phase(vlm, state):
    paths = tp_path(state, vlm)
    rec = {"path": paths["fsdp_tp"], "path_serve_2d": paths["serve_2d"]}
    state.clear()  # phase 8e's weights
    torch.cuda.empty_cache()
    gemma2 = get_config("gemma2-9b")
    need((gemma2.n_heads, gemma2.n_kv_heads, gemma2.head_dim, gemma2.window,
          gemma2.attn_softcap, gemma2.mixer_pattern[0]) == (16, 8, 256, 4096, 50.0,
                                                           "attn_local"), "gemma2-9b width")
    rec["seq_decode"] = []
    rec["shares"] = (tp_shares(vlm_cfg(1), (8, 16), rec["seq_decode"])
                     + tp_shares(gemma2, (16,), rec["seq_decode"]))
    rec["grid_shares"] = tp_grid_shares(vlm_cfg(1), TP_GRIDS)
    return rec


# B 1 x (256 prefix rows + 2048 tokens), 3 AdamW steps (lr 3e-4, wd 0.1), as
# dryrun_check's train step; the sharded losses within 1e-5 of train_loop's
TP_TRAIN_S, TP_TRAIN_STEPS, TP_TRAIN_LOSS_RTOL = 2048, 3, 1e-5
# shares: each output within 1e-4 of the unsplit layer's largest (fp32), each
# gradient within 2e-3 of its leaf's largest (train_check's tolerance); bf16 5e-2
TP_TRAIN_GRAD_TOL = 2e-3


def tp_train_shares(cfg, ranks):
    """(a) one full-width layer of ``cfg`` with its embedding, head and
    cross-entropy, fp32 then the same weights in bf16, B 1 x S 2560: for each
    W in ``ranks`` every rank's training share in turn (its weight blocks,
    ``tensor_parallel.share``), the sums over ``model`` applied here (the
    lookups' and row-parallel terms added, the cross-entropy's terms merged
    by ``Shares.merge_xent``; each column-parallel input fed to every rank,
    so autograd adds its gradient's terms), one backward; the loss, the
    layer's output and every gradient against the unsplit layer's. In bf16
    twice: the W terms of each sum added in bf16, one rounding an addition,
    as a bf16 all-reduce over ``model`` adds them; then added in fp32 and
    rounded to bf16 once. The phase holds the second to the bf16 tolerance
    and records the first beside it, with its worst leaf."""
    lm = init_params(dataclasses.replace(cfg, n_layers=1), seed=SEED, device="cuda",
                     dtype=torch.float32)
    block = lm.layers[0]
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, TP_S), generator=g, device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (1, TP_S), generator=g, device="cuda")
    positions = torch.arange(TP_S, device="cuda")
    recs, unsplit32 = [], None
    for dtype in (torch.float32, torch.bfloat16):
        lm.to(dtype).requires_grad_(True)
        names, params = zip(*lm.named_parameters())
        reset_counts()
        x, _ = block(lm._embed(tokens), positions)
        loss = common.softmax_xent(lm._logits(x), labels)
        grads = torch.autograd.grad(loss, params)
        want_launches = counts()
        want = {"loss": loss.detach(), "layer": x.detach(),
                **{n: gr for n, gr in zip(names, grads)}}
        del x, loss, grads
        if unsplit32 is None:
            unsplit32 = want
        for W, fp32_terms in [(W, f) for W in ranks
                              for f in ((False,) if dtype == torch.float32 else (False, True))]:
            shares = [tp.share(lm, None, r, W) for r in range(W)]

            def each(fn, given=None):
                """fn(axis, input) for every rank's share; ``given``, an input
                every rank reads, reaches it through a cast from fp32 where
                the terms add in fp32, so autograd adds its gradient's terms
                there."""
                src = given.float() if fp32_terms and given is not None else given
                out = []
                for axis, blocks, _ in shares:
                    with _reparametrize_module(lm, blocks):
                        out.append(fn(axis, None if src is None else src.to(dtype)))
                return out

            def add(terms):
                return (sum(t.float() for t in terms).to(dtype) if fp32_terms
                        else sum(terms))

            reset_counts()
            x = add(each(lambda axis, _: lm._embed(tokens, model_axis=axis)))
            x = x + add(each(lambda axis, h: block.attn(h, positions, axis=axis.layer(0)),
                             common.apply_norm(block.norm1, x)))
            x = x + add(each(lambda axis, h: block.mlp(h), common.apply_norm(block.norm2, x)))
            lse, gold = tp.Shares.merge_xent(
                each(lambda axis, h: axis.xent_terms(lm._logits(h, axis), labels), x))
            loss = common.masked_mean(lse - gold)
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            launches = counts()
            layer = shares[0][0].layer(0)
            need(layer.attn_sum and layer.mlp_sum and shares[0][0].head is not None,
                 f"{cfg.name} at {W}: no split")
            got = {"loss": loss.detach(), "layer": x.detach(),
                   **{n: gr for n, gr in zip(names, grads)}}
            del x, loss, grads, lse, gold
            err = {k: rel_err(got[k], want[k]) for k in want}
            outputs = ("loss", "layer")
            worst = max((k for k in err if k not in outputs), key=err.get)
            tol = (TP_FP32_TOL, TP_TRAIN_GRAD_TOL) if dtype == torch.float32 else \
                (TP_BF16_TOL, TP_BF16_TOL)
            rec = {"case": f"{cfg.name} layer ({cfg.n_heads}/{cfg.n_kv_heads} heads, "
                           f"{cfg.mlp_type}), {cfg.vocab_size}-way head and cross-entropy",
                   "model_ranks": W, "dtype": str(dtype)[6:], "B": 1, "S": TP_S,
                   "terms_added_in": "float32" if fp32_terms else str(dtype)[6:],
                   "rank_heads": rank_heads(layer, cfg),
                   "summed_gradients": sorted(n for n in names
                                              if shares[0][0].sums_gradient(n)),
                   "rel_err": {k: err[k] for k in outputs}, "worst_leaf": worst,
                   "worst_leaf_rel_err": err[worst], "leaves": len(names),
                   "tol": {"outputs": tol[0], "gradients": tol[1]},
                   "launches_shares": launches, "launches_unsplit": want_launches}
            if dtype == torch.bfloat16:
                for tag, side in (("unsplit_vs_fp32", want), ("shares_vs_fp32", got)):
                    e = {k: rel_err(side[k], unsplit32[k]) for k in unsplit32}
                    leaf = max((k for k in e if k not in outputs), key=e.get)
                    rec[tag] = {**{k: e[k] for k in outputs}, "worst_leaf": e[leaf],
                                "worst_leaf_name": leaf}
            print("tp_train_shares", json.dumps(rec), flush=True)
            kernel = {"wgmma": "flash_wgmma", "simt": "flash"}[
                fa_ops.kernel_for(dtype, cfg.head_dim)]
            need(launches == launch_counts(**{kernel: W}),
                 f"tp train shares {cfg.name} at {W} ({dtype}): launches {launches}")
            need(all(torch.isfinite(v.float()).all() for v in got.values()),
                 f"tp train shares {cfg.name} at {W}: non-finite")
            gated = dtype == torch.float32 or fp32_terms
            need(max(err[k] for k in outputs) <= tol[0] and (err[worst] <= tol[1] or not gated),
                 f"tp train shares {cfg.name} at {W} ({dtype}, terms in "
                 f"{rec['terms_added_in']}): {rec['rel_err']}, {worst} {err[worst]}")
            recs.append(rec)
            del shares, got
        del want
    del lm, unsplit32
    torch.cuda.empty_cache()
    return recs


def tp_train_path():
    """(c) internvl2-76b at full width, 1 layer, bf16 over fp32 masters, remat
    "nothing", B 1 x (256 + 2048): ``train_loop`` unsharded, then the same
    seeded weights and batches through ``ShardedModel`` on a 1-rank NCCL mesh
    (the split path with every split whole), one after the other (each holds
    about 47 GB: 2.96B parameters, their gradients and both moments in fp32);
    the losses, step ms under CUDA events and the flash launches a step (the
    forward and the group's recompute: 2)."""
    cfg = vlm_cfg(1)
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1),
                         total_steps=TP_TRAIN_STEPS, warmup_steps=1, remat_policy="nothing",
                         compute_dtype=torch.bfloat16)
    data = SyntheticLM(DataConfig(cfg.vocab_size, TP_TRAIN_S, 1, seed=SEED))
    rng = np.random.default_rng(SEED)
    batches = [{**data.batch(i), "prefix_embeds": rng.standard_normal(
        (1, VLM_P, cfg.d_model)).astype(np.float32)} for i in range(TP_TRAIN_STEPS)]

    def train(model, lm):
        events = []
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        lm, state, hist = train_loop(model, lm, timed_batches(batches, events), run,
                                     log_every=1)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        events.append(end)
        return {"losses": [h["loss"] for h in hist], "launches": counts(),
                "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    model = build_model(cfg)
    lm = model.init(SEED, torch.float32)
    n_params = sum(p.numel() for p in lm.parameters())
    unsharded = train(model, lm)
    del lm
    torch.cuda.empty_cache()
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES["fsdp_tp"]())
        lm = model.init(SEED, torch.float32)
        sharded = train(model, lm)
        del lm
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(sharded["losses"], unsharded["losses"])]
    per_step = launch_counts(flash_wgmma=2)
    rec = {"arch": cfg.name, "layers": 1, "params": n_params, "batch": 1, "prefix_rows": VLM_P,
           "seq": TP_TRAIN_S, "steps": TP_TRAIN_STEPS, "compute_dtype": "bfloat16",
           "master_dtype": "float32", "remat_policy": "nothing",
           "mesh": {"data": 1, "model": 1}, "strategy": "fsdp_tp", "unsharded": unsharded,
           "sharded": sharded, "loss_max_rel_err": max(rel), "loss_tol": TP_TRAIN_LOSS_RTOL,
           "launches_per_step_expected": per_step,
           "step_ms_median_warm": {k: float(np.median(r["step_ms"][1:]))
                                   for k, r in (("unsharded", unsharded),
                                                ("sharded", sharded))}}
    print("tp_train_path", json.dumps(rec), flush=True)
    want = {k: v * TP_TRAIN_STEPS for k, v in per_step.items()}
    need(unsharded["launches"] == want and sharded["launches"] == want,
         f"tp train launches {unsharded['launches']}, {sharded['launches']}; expected {want}")
    need(all(np.isfinite(sharded["losses"])) and max(rel) <= TP_TRAIN_LOSS_RTOL,
         f"tp train: sharded losses {sharded['losses']} against {unsharded['losses']}")
    return rec


def tp_train_phase():
    gemma2 = get_config("gemma2-9b")
    rec = {"path": tp_train_path()}
    rec["shares"] = tp_train_shares(vlm_cfg(1), (8, 16)) + tp_train_shares(gemma2, (16,))
    return rec


# ---------------------------------------------------------------------------
# Phase 8h2: sequence parallelism in sharded training
# ---------------------------------------------------------------------------

def sp_shares(cfg, ranks, parts=("mix", "feed_forward")):
    """(a) layer 0 of ``cfg`` at full width (or the halves ``parts`` of it),
    B 1 x S 2560, fp32 then bf16 cast from the same fp32 masters: for each
    W in ``ranks`` every rank's share in turn in the sequence form
    (``tensor_parallel.share`` with ``seq_len``, driven by
    ``tensor_parallel.seq_shares``: each rank normalizes its 2560/W
    positions, the gathers and reduce-scatters played there, their terms
    added in fp32), one backward of <out, gy> (+ the ranks' aux terms): the
    ranks' output blocks concatenated and every leaf's gradient (the norm
    scales' and the unsplit mixers' summed over the ranks at the masters)
    against the unsplit layer's; in bf16 also each side against the fp32
    unsplit layer. Flash and the scan launches counted over the shares'
    forward and backward."""
    lm = init_params(dataclasses.replace(cfg, n_layers=1), seed=SEED, device="cuda",
                     dtype=torch.float32)
    block = lm.layers[0]
    names = [n for n, _ in lm.named_parameters() if n.startswith("layers.0.")]
    masters = [lm.get_parameter(n).requires_grad_(True) for n in names]
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x32 = torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")
    gy = torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")
    positions = torch.arange(TP_S, device="cuda")

    def grads(out, auxs, x):
        """The output and the gradients of the input and every leaf the
        parts read."""
        loss = (out.float() * gy).sum() + sum(a.float() for a in auxs)
        got = torch.autograd.grad(loss, [x] + masters, allow_unused=True)
        return {"output": out.detach().float(), "input": got[0],
                **{n[len("layers.0."):]: gr for n, gr in zip(names, got[1:])
                   if gr is not None}}

    def unsplit(dtype, x):
        params = {n: t.to(dtype) for n, t in zip(names, masters)}
        with _reparametrize_module(lm, params):
            if "mix" in parts:
                out, aux = block(x, positions)
            else:
                out, aux = block.feed_forward(common.apply_norm(block.norm2, x))
                out = x + out
        return grads(out, [aux], x)

    recs, unsplit32 = [], None
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.clone().requires_grad_()
        reset_counts()
        want = unsplit(dtype, x.to(dtype))
        want_launches = counts()
        if unsplit32 is None:
            unsplit32 = want
        for W in ranks:
            shares = []
            for r in range(W):
                axis, params, _ = tp.share(lm, None, r, W, seq_len=TP_S)
                shares.append((axis, {n: params[n].to(dtype) for n in names}, None))
            x = x32.clone().requires_grad_()
            reset_counts()
            out, auxs = tp.seq_shares(lm, 0, shares, x.to(dtype), positions, parts)
            got = grads(out, auxs, x)
            torch.cuda.synchronize()
            launches = counts()
            axis, layer = shares[0][0], shares[0][0].layer(0)
            need(axis.seq is not None and axis.seq.hi - axis.seq.lo == TP_S // W,
                 f"sp shares {cfg.name} at {W}: no sequence split")
            err = {k: rel_err(got[k], want[k]) for k in want}
            worst = max((k for k in err if k != "output"), key=err.get)
            tol = (TP_FP32_TOL, TP_TRAIN_GRAD_TOL) if dtype == torch.float32 else \
                (TP_BF16_TOL, TP_BF16_TOL)
            rec = {"case": f"{cfg.name} layer 0 ({block.mixer}"
                           + (", MoE" if hasattr(block, "moe") else f", {cfg.mlp_type}")
                           + f"), {'+'.join(parts)}",
                   "model_ranks": W, "dtype": str(dtype)[6:], "B": 1, "S": TP_S,
                   "positions_a_rank": TP_S // W, "terms_added_in": "float32",
                   "splits": {"attn": layer.attn_sum, "mlp": layer.mlp_sum,
                              "moe": layer.moe_sum},
                   "summed_gradients": sorted(n[len("layers.0."):] for n in names
                                              if axis.sums_gradient(n)),
                   "rel_err": {"output": err["output"]}, "worst_gradient": worst,
                   "worst_gradient_rel_err": err[worst],
                   "norm_scale_rel_err": {k: err[k] for k in err if k.startswith("norm")},
                   "leaves": len(names), "tol": {"output": tol[0], "gradients": tol[1]},
                   "launches_shares": launches, "launches_unsplit": want_launches}
            if dtype == torch.bfloat16:
                for tag, side in (("unsplit_vs_fp32", want), ("shares_vs_fp32", got)):
                    e = {k: rel_err(side[k], unsplit32[k]) for k in unsplit32}
                    leaf = max((k for k in e if k != "output"), key=e.get)
                    rec[tag] = {"output": e["output"], "worst_gradient": e[leaf],
                                "worst_gradient_name": leaf}
            print("sp_train_shares", json.dumps(rec), flush=True)
            flash = {"wgmma": "flash_wgmma", "simt": "flash"}[
                fa_ops.kernel_for(dtype, cfg.head_dim)]
            expect = launch_counts(**({flash: W} if block.mixer == "attn" and "mix" in parts
                                      else {"rglru": 2 * W} if block.mixer == "rglru"
                                      else {}))
            need(launches == expect, f"sp shares {cfg.name} at {W} ({dtype}): launches "
                                     f"{launches}, expected {expect}")
            need(all(torch.isfinite(v.float()).all() for v in got.values()),
                 f"sp shares {cfg.name} at {W}: non-finite")
            need(err["output"] <= tol[0] and err[worst] <= tol[1],
                 f"sp shares {cfg.name} at {W} ({dtype}): output {err['output']}, "
                 f"{worst} {err[worst]}")
            recs.append(rec)
            del shares, got, out, auxs
        del want
    del lm, masters, unsplit32
    torch.cuda.empty_cache()
    return recs


def sp_train_phase(tp_train):
    """(a) the shares: one internvl2-76b layer at 8 and 16 ranks, one
    recurrentgemma-9b RG-LRU layer (the scan on the gathered sequence) at
    16, one qwen3-moe MoE half-block (``norm2``, the experts' combine
    reduce-scattered, the residual) at 16; (b) ``tp_train``'s 1-rank path
    under ``fsdp_tp``: a one-rank axis splits no sequence, and its losses
    are ``train_loop``'s bit for bit."""
    cfg = vlm_cfg(1)
    mesh = {"data": 1, "model": 1}
    stream = (1, VLM_P + TP_TRAIN_S, cfg.d_model)
    path = tp_train["path"]
    rec = {"path": {"strategy": path["strategy"], "mesh": mesh,
                    "stream_split": shd.stream_split(mesh, shd.STRATEGIES["fsdp_tp"](), stream,
                                                     {"data": 0, "model": 0}),
                    "losses": path["sharded"]["losses"],
                    "train_loop_losses": path["unsharded"]["losses"],
                    "bit_equal": path["sharded"]["losses"] == path["unsharded"]["losses"]}}
    print("sp_train_path", json.dumps(rec["path"]), flush=True)
    need(rec["path"]["stream_split"] is None and rec["path"]["bit_equal"],
         f"sp train: the 1-rank path {rec['path']}")
    rgemma, moe = get_config("recurrentgemma-9b"), get_config("qwen3-moe-235b-a22b")
    need(rgemma.mixer_pattern[0] == "rglru" and moe.is_moe, "sp train configs")
    rec["shares"] = (sp_shares(cfg, (8, 16)) + sp_shares(rgemma, (16,))
                     + sp_shares(moe, (16,), parts=("feed_forward",)))
    return rec


# ---------------------------------------------------------------------------
# Phase 8h3: the RG-LRU split on the model axis
# ---------------------------------------------------------------------------

# (b): B 2 x S 2560 served with 16 greedy steps; 2 AdamW steps at B 1 x S 2048
RNN_B, RNN_STEPS, RNN_TRAIN_S, RNN_TRAIN_STEPS = 2, 16, 2048, 2


def rnn_shares(cfg, ranks):
    """(a) recurrentgemma-9b's layer 0 at full width, its mixer half (``norm1``,
    the RG-LRU, the residual), B 1 x S 2560, fp32 then bf16 cast from the same
    fp32 masters: for each W in ``ranks`` every rank's share in turn on its
    4096/W channels (``tensor_parallel.share``), in the plain form (every
    rank reads the whole normed stream, its terms added in fp32) and in the
    sequence form (``tensor_parallel.seq_shares``: each rank normalizes its
    2560/W positions, its whole term reduce-scattered there), one backward
    of <out, gy>: the output and the input's and every leaf's gradient (the
    gates' from their blocks) against the unsplit half's; in bf16 also each
    side against the fp32 unsplit half. Scan launches counted over the
    shares' forward and backward: two a rank."""
    lm = init_params(dataclasses.replace(cfg, n_layers=1), seed=SEED, device="cuda",
                     dtype=torch.float32)
    block = lm.layers[0]
    need(block.mixer == "rglru", f"rnn shares: layer 0 of {cfg.name} is {block.mixer}")
    names = [n for n, _ in lm.named_parameters()
             if n.startswith(("layers.0.norm1", "layers.0.rglru."))]
    masters = [lm.get_parameter(n).requires_grad_(True) for n in names]
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x32 = torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")
    gy = torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")
    positions = torch.arange(TP_S, device="cuda")

    def grads(out, x):
        got = torch.autograd.grad((out.float() * gy).sum(), [x] + masters)
        return {"output": out.detach().float(), "input": got[0],
                **{n[len("layers.0."):]: gr for n, gr in zip(names, got[1:])}}

    def plain_form(shares, x):
        with _reparametrize_module(lm, shares[0][1]):  # norm1 is whole on every rank
            h = common.apply_norm(block.norm1, x).float()
        terms = []
        for axis, params, _ in shares:
            with _reparametrize_module(lm, params):
                terms.append(block.mix(h.to(x.dtype), positions, axis.layer(0)))
        return x + sum(t.float() for t in terms).to(x.dtype)

    recs, unsplit32 = [], None
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.clone().requires_grad_()
        reset_counts()
        with _reparametrize_module(lm, {n: t.to(dtype) for n, t in zip(names, masters)}):
            xd = x.to(dtype)
            want = grads(xd + block.mix(common.apply_norm(block.norm1, xd), positions), x)
        want_launches = counts()
        if unsplit32 is None:
            unsplit32 = want
        for W, form in [(W, f) for W in ranks for f in ("plain", "sequence")]:
            shares = []
            for r in range(W):
                axis, params, _ = tp.share(lm, None, r, W,
                                           seq_len=TP_S if form == "sequence" else None)
                shares.append((axis, {n: params[n].to(dtype) for n in names}, None))
            x = x32.clone().requires_grad_()
            reset_counts()
            if form == "sequence":
                out, _ = tp.seq_shares(lm, 0, shares, x.to(dtype), positions, parts=("mix",))
            else:
                out = plain_form(shares, x.to(dtype))
            got = grads(out, x)
            torch.cuda.synchronize()
            launches = counts()
            axis, layer = shares[0][0], shares[0][0].layer(0)
            width = cfg.rnn_width // W
            need(layer.rglru_sum and layer.rnn.hi - layer.rnn.lo == width
                 and (axis.seq is not None) == (form == "sequence"),
                 f"rnn shares at {W} ({form}): the split {layer.rnn}, sequence {axis.seq}")
            err = {k: rel_err(got[k], want[k]) for k in want}
            worst = max((k for k in err if k != "output"), key=err.get)
            tol = (TP_FP32_TOL, TP_TRAIN_GRAD_TOL) if dtype == torch.float32 else \
                (TP_BF16_TOL, TP_BF16_TOL)
            rec = {"case": f"{cfg.name} layer 0 (RG-LRU, {cfg.n_heads} gate blocks), norm1 + "
                           f"mix", "model_ranks": W, "form": form, "dtype": str(dtype)[6:],
                   "B": 1, "S": TP_S, "channels_a_rank": width,
                   "gate_blocks_a_rank": cfg.n_heads // W,
                   "scan_shape": [1, TP_S, width], "scan_route": lru_ops.route_for(dtype, width),
                   "terms_added_in": "float32",
                   "block_gradients": sorted(n[len("layers.0."):] for n in names
                                             if axis.split(n) is not None),
                   "summed_gradients": sorted(n[len("layers.0."):] for n in names
                                              if axis.sums_gradient(n)),
                   "rel_err": {"output": err["output"]}, "worst_gradient": worst,
                   "worst_gradient_rel_err": err[worst],
                   "gates_rel_err": {k: err[k] for k in err if ".gate_" in k},
                   "leaves": len(names), "tol": {"output": tol[0], "gradients": tol[1]},
                   "launches_shares": launches, "launches_unsplit": want_launches}
            if dtype == torch.bfloat16:
                for tag, side in (("unsplit_vs_fp32", want), ("shares_vs_fp32", got)):
                    e = {k: rel_err(side[k], unsplit32[k]) for k in unsplit32}
                    leaf = max((k for k in e if k != "output"), key=e.get)
                    rec[tag] = {"output": e["output"], "worst_gradient": e[leaf],
                                "worst_gradient_name": leaf}
            print("rnn_split_shares", json.dumps(rec), flush=True)
            need(launches == launch_counts(rglru=2 * W),
                 f"rnn shares at {W} ({form}, {dtype}): launches {launches}")
            need(all(torch.isfinite(v.float()).all() for v in got.values()),
                 f"rnn shares at {W} ({form}): non-finite")
            need(err["output"] <= tol[0] and err[worst] <= tol[1],
                 f"rnn shares at {W} ({form}, {dtype}): output {err['output']}, "
                 f"{worst} {err[worst]}")
            recs.append(rec)
            del shares, got, out
        del want
    del lm, masters, unsplit32
    torch.cuda.empty_cache()
    return recs


def rnn_serve(run_model, params, toks, full, fed=None):
    """A prefill of ``toks`` (cold, then warm), then 16 decode steps, each fed
    the last call's greedy token (or the column of ``fed``): (each call's
    greedy token [B, 16], every call's fp32 logits, the prefills' ms and
    decode ms a step under CUDA events, the prefill's and the steps'
    launches, pos)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    prefill_ms = []
    with torch.no_grad():
        for _ in range(2):
            cache = run_model.init_cache(toks.shape[0], toks.shape[1] + RNN_STEPS,
                                         torch.bfloat16)
            reset_counts()
            start.record()
            logits, cache = run_model.prefill(params, {"tokens": toks}, cache)
            end.record()
            torch.cuda.synchronize()
            prefill_ms.append(start.elapsed_time(end))
            prefill_launches = counts()
        out = [full(logits).float()]
        reset_counts()
        start.record()
        for i in range(RNN_STEPS):
            tok = out[-1].argmax(-1) if fed is None else fed[:, i:i + 1]
            logits, cache = run_model.decode_step(params, cache, tok)
            out.append(full(logits).float())
        end.record()
        torch.cuda.synchronize()
    logits = torch.stack(out)  # [1 + steps, B, 1, V]
    return {"tokens": logits[:RNN_STEPS, :, 0].argmax(-1).T.cpu(), "logits": logits,
            "prefill_ms": prefill_ms, "decode_ms_per_step": start.elapsed_time(end) / RNN_STEPS,
            "prefill_launches": prefill_launches, "decode_launches": counts(),
            "pos": cache["pos"]}


def train_both_sides(cfg, n_steps, batch, seq):
    """``n_steps`` AdamW steps of ``cfg`` (bf16 compute over fp32 masters from
    SEED, remat "nothing", B ``batch`` x S ``seq`` from ``SyntheticLM``)
    through ``train_loop``, unsharded and then through ``ShardedModel`` on a
    1-rank NCCL mesh under ``fsdp_tp``: each side's (losses, launches, step
    ms under CUDA events)."""
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1),
                         total_steps=n_steps, warmup_steps=1, remat_policy="nothing",
                         compute_dtype=torch.bfloat16)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=SEED))
    batches = [data.batch(i) for i in range(n_steps)]

    def train(model):
        lm = model.init(SEED, torch.float32)
        events = []
        reset_counts()
        lm, _, hist = train_loop(model, lm, timed_batches(batches, events), run, log_every=1)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        events.append(end)
        return {"losses": [h["loss"] for h in hist], "launches": counts(),
                "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])]}

    unsharded = train(build_model(cfg))
    torch.cuda.empty_cache()
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        sharded = train(ShardedModel(build_model(cfg), mesh, shd.STRATEGIES["fsdp_tp"]()))
    torch.cuda.empty_cache()
    return unsharded, sharded


def rnn_path():
    """(b) recurrentgemma-9b at full width, one (rglru, rglru, attn_local)
    group, on a 1-rank NCCL mesh under ``fsdp_tp`` (each RG-LRU layer on the
    split's path with one block of all 4096 channels, its state read where
    it lies): a bf16 prefill of B 2 x S 2560 and 16 greedy decode steps,
    unsharded then through ``ShardedModel`` (the weights sharded in place),
    the sharded steps fed the unsharded greedy tokens: each call's greedy
    token equal (a flip is reported with the unsharded top-2 margin, and
    passes only where that margin is below the logits' difference: a bf16
    near-tie); then 2 AdamW steps (bf16 over fp32 masters, remat
    "nothing", B 1 x S 2048) through ``train_loop`` unsharded and sharded,
    the losses bit-equal; ms of each side. The serving runs again under
    ``serve_2d``'s rules on the one rank (``data`` holds one rank: the
    layer on its ``model`` block, as under ``fsdp_tp``), its tokens equal
    to ``fsdp_tp``'s."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=3)
    need(cfg.n_groups_and_tail() == (1, 0), "rnn path: one group")
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    toks = torch.randint(0, cfg.vocab_size, (RNN_B, TP_S), generator=g, device="cuda")
    params = build_model(cfg).init(SEED, torch.bfloat16)
    plain = rnn_serve(build_model(cfg), params, toks, lambda t: t)
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES["fsdp_tp"]())
        model.shard(params)  # in place: each weight a DTensor over the one rank
        layer = model.model_axis(params, None, (), 1).layer(0)
        sharded = rnn_serve(model, params, toks, lambda t: t.full_tensor(),
                            fed=plain["tokens"].to(toks.device))
        # serve_2d on the one rank: data holds one rank, so no chunk (the
        # model block of all 4096 channels, as under fsdp_tp)
        model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES["serve_2d"]())
        layer_2d = model.model_axis(params, model.init_cache(1, 1), (), 1,
                                    stationary=True).layer(0)
        sharded_2d = rnn_serve(model, params, toks, lambda t: t.full_tensor(),
                               fed=plain["tokens"].to(toks.device))
    del params
    torch.cuda.empty_cache()
    want, got = plain["logits"], sharded["logits"]
    top2 = want[:RNN_STEPS, :, 0].topk(2, dim=-1).values  # [steps, B, 2]
    margin = (top2[..., 0] - top2[..., 1]).T.cpu()
    diff = (got - want).abs().amax(dim=(1, 2, 3)).cpu()
    flips = [{"row": r, "step": i, "margin": float(margin[r, i]),
              "max_abs_dlogit": float(diff[i])}
             for r, i in torch.nonzero(sharded["tokens"] != plain["tokens"]).tolist()]
    serve = {"batch": RNN_B, "prompt_len": TP_S, "steps": RNN_STEPS,
             "rglru_split": list(layer.rnn), "tokens_equal": not flips, "flips": flips,
             "prefill_logits_equal": bool(torch.equal(got[0], want[0])),
             "logits_rel_err": max(rel_err(a, b) for a, b in zip(got, want)),
             "logits_tol": TP_BF16_TOL,
             **{f"{k}_{side}": r[k] for side, r in (("unsharded", plain), ("sharded", sharded))
                for k in ("prefill_ms", "decode_ms_per_step", "prefill_launches",
                          "decode_launches")}}
    serve_2d = {"rglru_split": list(layer_2d.rnn),
                "rglru_chunk": None if layer_2d.rglru_block is None else list(layer_2d.rglru_block),
                "tokens_equal_fsdp_tp": bool(torch.equal(sharded_2d["tokens"],
                                                          sharded["tokens"])),
                "logits_rel_err": max(rel_err(a, b) for a, b in zip(sharded_2d["logits"], want)),
                **{k: sharded_2d[k] for k in ("prefill_ms", "decode_ms_per_step",
                                             "prefill_launches", "decode_launches")}}

    unsharded, sharded_train = train_both_sides(cfg, RNN_TRAIN_STEPS, 1, RNN_TRAIN_S)
    per_step = launch_counts(flash_wgmma=2, rglru=6)
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": {"data": 1, "model": 1},
           "strategy": "fsdp_tp", "serve": serve, "serve_2d": serve_2d,
           "train": {"batch": 1, "seq": RNN_TRAIN_S, "steps": RNN_TRAIN_STEPS,
                     "compute_dtype": "bfloat16", "master_dtype": "float32",
                     "remat_policy": "nothing", "unsharded": unsharded,
                     "sharded": sharded_train,
                     "bit_equal": sharded_train["losses"] == unsharded["losses"],
                     "launches_per_step_expected": per_step}}
    print("rnn_split_path", json.dumps(rec), flush=True)
    for side in ("unsharded", "sharded"):
        need(serve[f"prefill_launches_{side}"] == launch_counts(flash_wgmma=1, rglru=2)
             and serve[f"decode_launches_{side}"] == launch_counts(),
             f"rnn path {side} launches {serve[f'prefill_launches_{side}']}, "
             f"{serve[f'decode_launches_{side}']}")
    need(layer.rnn is not None and layer.rnn.hi - layer.rnn.lo == cfg.rnn_width,
         f"rnn path: the RG-LRU split {layer.rnn}")
    need(serve_2d["prefill_launches"] == launch_counts(flash_wgmma=1, rglru=2)
         and serve_2d["decode_launches"] == launch_counts(),
         f"rnn path serve_2d launches {serve_2d['prefill_launches']}, "
         f"{serve_2d['decode_launches']}")
    need(layer_2d.rnn == shd.Split(0, ("model",), 0, cfg.rnn_width)
         and layer_2d.rglru_block is None, f"rnn path serve_2d: the split {layer_2d.rnn}")
    need(sharded_2d["pos"] == TP_S + RNN_STEPS and serve_2d["tokens_equal_fsdp_tp"]
         and serve_2d["logits_rel_err"] <= TP_BF16_TOL,
         f"rnn path serve_2d: tokens equal {serve_2d['tokens_equal_fsdp_tp']}, logits "
         f"{serve_2d['logits_rel_err']}")
    need(sharded["pos"] == TP_S + RNN_STEPS, f"rnn path pos {sharded['pos']}")
    need(torch.isfinite(got).all() and serve["logits_rel_err"] <= TP_BF16_TOL,
         f"rnn path logits {serve['logits_rel_err']}")
    need(all(f["margin"] <= f["max_abs_dlogit"] for f in flips),
         f"rnn path: tokens differ beyond a near-tie: {flips}")
    want_launches = {k: v * RNN_TRAIN_STEPS for k, v in per_step.items()}
    need(unsharded["launches"] == want_launches and sharded_train["launches"] == want_launches,
         f"rnn path train launches {unsharded['launches']}, {sharded_train['launches']}")
    need(all(np.isfinite(unsharded["losses"])) and rec["train"]["bit_equal"],
         f"rnn path: sharded losses {sharded_train['losses']}, train_loop's "
         f"{unsharded['losses']}")
    return rec


# (c): serve_2d's grids, a chunk of 256 channels (one gate block) a rank, and
# (data 4 x model 8), a chunk of 128 (half a block: the block gathered over
# model); a prefill and 4 steps, and decode_32k's 128 rows from a seeded state
RNN_GRIDS = TP_GRIDS + ({"data": 4, "model": 8},)
RNN_GRID_DECODE, RNN_GRID_DECODE_B = 4, 128


def rnn_grid_shares(cfg, grids):
    """(c) recurrentgemma-9b's layer 0 at full width (``norm1``, the RG-LRU,
    ``norm2``, the MLP, both residuals) under ``serve_2d`` on each grid of
    ``grids``, fp32 then the same weights in bf16: every rank at once, a
    thread a rank (``tensor_parallel.thread_shares``), each serving the
    RG-LRU on its (data, model) chunk of the 4096 channels as they lie at
    rest (``conv_w``, ``conv_b``, ``lam``, ``w_out``'s rows and the state
    ``h`` and ``conv``; ``w_in_rec``, ``w_in_gate`` and the MLP's weights
    their (embed block x model block); the gates whole, read by the
    chunk's columns), only activations moving. Two runs: a B 1 x S 2560
    prefill and 4 decode steps from the carried state, and one decode step
    of decode_32k's 128 rows from a seeded state (fp32 ``h``, ``conv`` in
    the activation dtype). Every rank's stream of every call against the
    unsplit layer's (``Block.prefill`` / ``decode``): fp32 within 1e-4 of
    the largest, bf16 within 5e-2 beside the unsplit bf16 layer's own error
    against fp32 (the partial products added in bf16, as a bf16 all-reduce
    adds them); each rank's ``h`` and ``conv`` against that chunk of the
    unsplit state; the ranks' streams bit-equal; one scan launch a rank a
    prefill, none in decode; wall ms of each run beside the unsplit run's."""
    lcfg = dataclasses.replace(cfg, n_layers=1)
    lm = init_params(lcfg, seed=SEED, device="cuda", dtype=torch.float32)
    block, model = lm.layers[0], build_model(lcfg)
    need(block.mixer == "rglru", f"rnn grid: layer 0 of {cfg.name} is {block.mixer}")
    rules = shd.STRATEGIES["serve_2d"]()
    B = RNN_GRID_DECODE_B
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    prompt = [torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")]
    prompt += [torch.randn(1, 1, cfg.d_model, generator=g, device="cuda")
               for _ in range(RNN_GRID_DECODE)]
    step = [torch.randn(B, 1, cfg.d_model, generator=g, device="cuda")]
    carried = {"h": torch.randn(B, cfg.rnn_width, generator=g, device="cuda"),
               "conv": torch.randn(B, cfg.conv_width - 1, cfg.rnn_width, generator=g,
                                   device="cuda")}
    runs = {"prefill_and_decode": (1, prompt), "decode_32k_step": (B, step)}
    positions = torch.arange(TP_S, device="cuda")
    leaves = ("rglru.w_in_rec", "rglru.w_out", "rglru.conv_w", "rglru.lam", "rglru.gate_a",
              "mlp.w_up")

    def cache(rows, dtype):
        c = model.init_cache(rows, 1, dtype)
        if rows == B:  # the seeded carried state
            for k, t in carried.items():
                c["layers"][0][k].copy_(t)
        return c

    def calls(blk, xs, c, layer):
        return [blk.prefill(x, positions, c, layer) if x.shape[1] > 1
                else blk.decode(x, TP_S, c, layer) for x in xs]

    recs, unsplit32 = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        lm.to(dtype)
        for run, (rows, xs32) in runs.items():
            xs = [x.to(dtype) for x in xs32]
            want_c = cache(rows, dtype)["layers"][0]
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                want = calls(block, xs, want_c, None)
            torch.cuda.synchronize()
            want_ms, want_launches = (time.perf_counter() - t0) * 1e3, counts()
            unsplit32.setdefault(run, [w.float() for w in want])
            prefills = sum(x.shape[1] > 1 for x in xs)

            def one(blk, layer, c):
                outs = calls(blk, xs, c["layers"][0], layer)
                blocks = {n: list(getattr(getattr(blk, n.split(".")[0]), n.split(".")[1]).shape)
                          for n in leaves}
                return outs, layer, blocks

            for grid in grids:
                n_ranks = grid["data"] * grid["model"]
                width = cfg.rnn_width // n_ranks
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                with torch.no_grad():
                    got, caches = tp.thread_shares(lm, "layers", 0, grid, cache(rows, dtype),
                                                   one, rules)
                torch.cuda.synchronize()
                ms, launches = (time.perf_counter() - t0) * 1e3, counts()
                layer = got[0][1]
                state_err = {k: max(rel_err(c["layers"][0][k],
                                            want_c[k][..., lay.rnn.lo:lay.rnn.hi])
                                    for (_, lay, _), c in zip(got, caches))
                             for k in ("h", "conv")}
                rec = {"case": f"{cfg.name} layer 0 (RG-LRU: {cfg.rnn_width} channels in "
                               f"{cfg.n_heads} gate blocks; {cfg.mlp_type} d_ff {cfg.d_ff})",
                       "strategy": "serve_2d", "grid": grid, "run": run,
                       "dtype": str(dtype)[6:], "rows": rows, "calls": len(xs),
                       "S": xs[0].shape[1], "channels_a_rank": width,
                       "gate_block": cfg.rnn_width // cfg.n_heads,
                       "scan_shape": [1, TP_S, width] if prefills else None,
                       "rank_blocks": got[0][2], "terms_added_in": str(dtype)[6:],
                       "rel_err": [max(rel_err(o[i], want[i]) for o, _, _ in got)
                                   for i in range(len(xs))],
                       "state_rel_err": state_err,
                       "tol": TP_FP32_TOL if dtype == torch.float32 else TP_BF16_TOL,
                       "ranks_equal": all(torch.equal(a, b) for o, _, _ in got
                                          for a, b in zip(o, got[0][0])),
                       "ms": ms, "unsplit_ms": want_ms, "launches": launches,
                       "launches_unsplit": want_launches}
                if dtype == torch.bfloat16:
                    rec["unsplit_vs_fp32"] = max(rel_err(a, b)
                                                 for a, b in zip(want, unsplit32[run]))
                    rec["shares_vs_fp32"] = max(rel_err(o[i], unsplit32[run][i])
                                                for o, _, _ in got for i in range(len(xs)))
                print("rnn_grid_shares", json.dumps(rec), flush=True)
                tag = f"rnn grid {grid} {run} ({dtype})"
                axis = layer.axis
                need(layer.rglru_block is not None and layer.rnn.hi - layer.rnn.lo == width
                     and axis.split("layers.0.rglru.w_out").axes == ("data", "model")
                     and axis.split("layers.0.rglru.gate_a") is None
                     and axis.stationary("layers.0.rglru.w_in_rec") is not None,
                     f"{tag}: the chunk {layer.rnn}, blocks {rec['rank_blocks']}")
                need(launches == launch_counts(rglru=n_ranks * prefills)
                     and want_launches == launch_counts(rglru=prefills),
                     f"{tag}: launches {launches}, unsplit {want_launches}")
                need(rec["ranks_equal"], f"{tag}: the ranks' streams differ")
                need(all(torch.isfinite(t.float()).all() for o, _, _ in got for t in o),
                     f"{tag}: non-finite")
                need(max(rec["rel_err"]) <= rec["tol"]
                     and max(state_err.values()) <= rec["tol"],
                     f"{tag}: streams {rec['rel_err']}, state {state_err}")
                recs.append(rec)
                del got, caches
            del want, want_c
    del lm, unsplit32
    torch.cuda.empty_cache()
    return recs


def rnn_split_phase():
    """(a) the shares of one full-width RG-LRU layer at 8 and 16 ranks; (b)
    the 1-rank path's serving (under ``fsdp_tp`` and ``serve_2d``) and
    training; (c) the layer under ``serve_2d`` on the (data x model) grids,
    every rank a thread."""
    cfg = get_config("recurrentgemma-9b")
    need((cfg.d_model, cfg.rnn_width, cfg.n_heads, cfg.conv_width) == (4096, 4096, 16, 4),
         "recurrentgemma-9b width")
    return {"shares": rnn_shares(cfg, (8, 16)), "path": rnn_path(),
            "grid_shares": rnn_grid_shares(cfg, RNN_GRIDS)}


# ---------------------------------------------------------------------------
# Phase 8h4: the RWKV-6 split on the model axis in serving and in training
# ---------------------------------------------------------------------------

# (a): B 1 x S 2560 and 4 decode steps; (b): 4 layers, B 4 x S 2560, 16 steps
RWKV_DECODE, RWKV_LAYERS, RWKV_B = 4, 4, 4


def rwkv_shares(cfg, ranks):
    """(a) rwkv6-7b's layer 0 at full width (``norm1``, the time mix,
    ``norm2``, the channel mix, both residuals): for each W in ``ranks``
    every rank's share in turn (``tensor_parallel.share``: the time mix on
    its 64/W heads and its block of the WKV state, the channel mix on its
    14336/W ``d_ff`` block), a B 1 x S 2560 prefill and 4 decode steps from
    the carried state (``tensor_parallel.rwkv_shares``: the time mix's terms
    and the channel mix's value terms added in fp32), against the unsplit
    layer (``Block.prefill`` / ``decode``), fp32 then bf16 cast from the
    same fp32 weights; each rank's WKV block against that block of the
    unsplit state; in bf16 also each side against the fp32 unsplit layer.
    wkv6 launches counted over the shares: one a rank a call."""
    lcfg = dataclasses.replace(cfg, n_layers=1)
    lm = init_params(lcfg, seed=SEED, device="cuda", dtype=torch.float32)
    block, model = lm.layers[0], build_model(lcfg)
    need(block.mixer == "rwkv", f"rwkv shares: layer 0 of {cfg.name} is {block.mixer}")
    H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    xs = [torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")]
    xs += [torch.randn(1, 1, cfg.d_model, generator=g, device="cuda") for _ in range(RWKV_DECODE)]
    n_calls = len(xs)

    def cache(dtype):
        return model.init_cache(1, TP_S + RWKV_DECODE, dtype)

    recs, unsplit32 = [], None
    for dtype in (torch.float32, torch.bfloat16):
        whole = {n: p.to(dtype) for n, p in lm.named_parameters()}
        want_c = cache(dtype)["layers"][0]
        reset_counts()
        with torch.no_grad(), _reparametrize_module(lm, whole):
            want = [block.prefill(xs[0].to(dtype), torch.arange(TP_S, device="cuda"), want_c)]
            want += [block.decode(x.to(dtype), TP_S + i, want_c) for i, x in enumerate(xs[1:])]
        torch.cuda.synchronize()
        want_launches = counts()
        if unsplit32 is None:
            unsplit32 = [w.float() for w in want]
        for W in ranks:
            shares = []
            for r in range(W):
                axis, params, rank_cache = tp.share(lm, cache(dtype), r, W)
                shares.append((axis, {n: t.to(dtype) for n, t in params.items()}, rank_cache))
            reset_counts()
            with torch.no_grad():
                got = [tp.rwkv_shares(lm, 0, shares, xs[0].to(dtype), carried=False)]
                got += [tp.rwkv_shares(lm, 0, shares, x.to(dtype), carried=True)
                        for x in xs[1:]]
            torch.cuda.synchronize()
            launches = counts()
            layer = shares[0][0].layer(0)
            heads, ff = H // W, cfg.d_ff // W
            need(layer.tm_sum and layer.tm.hi - layer.tm.lo == heads and layer.cm_sum
                 and layer.cm.hi - layer.cm.lo == ff,
                 f"rwkv shares at {W}: the splits {layer.tm}, {layer.cm}")
            err = max(rel_err(a, b) for a, b in zip(got, want))
            state_err = max(rel_err(rc["layers"][0]["wkv"],
                                    want_c["wkv"][:, a.layer(0).tm.lo:a.layer(0).tm.hi])
                            for a, _, rc in shares)
            tol = TP_FP32_TOL if dtype == torch.float32 else TP_BF16_TOL
            rec = {"case": f"{cfg.name} layer 0 (RWKV-6: {H} heads of {K}, d_ff {cfg.d_ff}), "
                           "prefill + decode", "model_ranks": W, "dtype": str(dtype)[6:],
                   "B": 1, "S": TP_S, "decode_steps": RWKV_DECODE, "heads_a_rank": heads,
                   "d_ff_a_rank": ff, "wkv_shape_a_rank": [1, TP_S, heads, K],
                   "terms_added_in": "float32", "rel_err": err, "wkv_state_rel_err": state_err,
                   "tol": tol, "launches_shares": launches, "launches_unsplit": want_launches}
            if dtype == torch.bfloat16:
                rec["unsplit_vs_fp32"] = max(rel_err(a, b) for a, b in zip(want, unsplit32))
                rec["shares_vs_fp32"] = max(rel_err(a, b) for a, b in zip(got, unsplit32))
            print("rwkv_split_shares", json.dumps(rec), flush=True)
            need(launches == launch_counts(wkv=W * n_calls)
                 and want_launches == launch_counts(wkv=n_calls),
                 f"rwkv shares at {W} ({dtype}): launches {launches}, unsplit {want_launches}")
            need(all(torch.isfinite(t.float()).all() for t in got),
                 f"rwkv shares at {W}: non-finite")
            need(err <= tol and state_err <= tol,
                 f"rwkv shares at {W} ({dtype}): output {err}, state {state_err}")
            recs.append(rec)
            del shares, got
        del want, want_c, whole
    del lm, unsplit32
    torch.cuda.empty_cache()
    return recs


def rwkv_path(cfg, strategies=("fsdp_tp", "serve_2d")):
    """(b) rwkv6-7b at full width cut to 4 layers, on a 1-rank NCCL mesh
    under each of ``strategies``' rules (each layer on the split's path with
    one block of all 64 heads and all 14336 ``d_ff`` columns, its WKV state
    read and written where it lies; under ``serve_2d`` no ``embed`` block
    stays, the ``data`` axis holding one rank): a bf16 prefill of B 4 x S
    2560 and 16 greedy decode steps, unsharded then through
    ``ShardedModel`` (the weights sharded in place), the sharded steps fed
    the unsharded greedy tokens: each call's greedy token equal (a flip is
    reported with the unsharded top-2 margin, and passes only where that
    margin is below the logits' difference: a bf16 near-tie), every call's
    logits within 5e-2 of the largest; ms of each side; 4 wkv6 launches a
    prefill and 4 a step on each side; the second strategy's tokens equal
    to the first's. -> the records by strategy."""
    cfg = dataclasses.replace(cfg, n_layers=RWKV_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    toks = torch.randint(0, cfg.vocab_size, (RWKV_B, TP_S), generator=g, device="cuda")
    params = build_model(cfg).init(SEED, torch.bfloat16)
    plain = rnn_serve(build_model(cfg), params, toks, lambda t: t)
    recs = {}
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        # in place: each weight a DTensor over the one rank
        ShardedModel(build_model(cfg), mesh, shd.STRATEGIES[strategies[0]]()).shard(params)
        for strategy in strategies:
            model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES[strategy]())
            layer = model.model_axis(params, model.init_cache(1, 1), (), 1,
                                     stationary=True).layer(0)
            sharded = rnn_serve(model, params, toks, lambda t: t.full_tensor(),
                                fed=plain["tokens"].to(toks.device))
            recs[strategy] = rwkv_path_record(cfg, strategy, plain, sharded, layer)
    del params
    torch.cuda.empty_cache()
    first, second = (recs[s] for s in strategies)
    second[f"{strategies[0]}_decode_ms_per_step"] = first["decode_ms_per_step_sharded"]
    second[f"tokens_equal_{strategies[0]}"] = second["argmax"] == first["argmax"]
    for rec in recs.values():
        print("rwkv_split_path", json.dumps(rec), flush=True)
    need(second[f"tokens_equal_{strategies[0]}"],
         f"rwkv path {strategies[1]}: its tokens differ from {strategies[0]}'s on one rank")
    return recs


def rwkv_path_record(cfg, strategy, plain, sharded, layer):
    """(b)'s record of one strategy's sharded calls against the unsharded
    ones, and its checks."""
    want, got = plain["logits"], sharded["logits"]
    top2 = want[:RNN_STEPS, :, 0].topk(2, dim=-1).values  # [steps, B, 2]
    margin = (top2[..., 0] - top2[..., 1]).T.cpu()
    diff = (got - want).abs().amax(dim=(1, 2, 3)).cpu()
    flips = [{"row": r, "step": i, "margin": float(margin[r, i]),
              "max_abs_dlogit": float(diff[i])}
             for r, i in torch.nonzero(sharded["tokens"] != plain["tokens"]).tolist()]
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": {"data": 1, "model": 1},
           "strategy": strategy, "batch": RWKV_B, "prompt_len": TP_S, "steps": RNN_STEPS,
           "time_mix_heads": list(layer.tm), "channel_mix_d_ff": list(layer.cm),
           "embed_blocks_stay": [layer.tm_block is not None, layer.cm_block is not None],
           "tokens_equal": not flips, "flips": flips, "argmax": sharded["tokens"].tolist(),
           "prefill_logits_equal": bool(torch.equal(got[0], want[0])),
           "logits_rel_err": max(rel_err(a, b) for a, b in zip(got, want)),
           "logits_tol": TP_BF16_TOL,
           **{f"{k}_{side}": r[k] for side, r in (("unsharded", plain), ("sharded", sharded))
              for k in ("prefill_ms", "decode_ms_per_step", "prefill_launches",
                        "decode_launches")}}
    tag = f"rwkv path {strategy}"
    for side in ("unsharded", "sharded"):
        need(rec[f"prefill_launches_{side}"] == launch_counts(wkv=RWKV_LAYERS)
             and rec[f"decode_launches_{side}"] == launch_counts(wkv=RWKV_LAYERS * RNN_STEPS),
             f"{tag} {side} launches {rec[f'prefill_launches_{side}']}, "
             f"{rec[f'decode_launches_{side}']}")
    need(layer.tm_sum and layer.tm.hi - layer.tm.lo == cfg.d_model // cfg.rwkv_head_dim
         and layer.cm_sum and layer.cm.hi - layer.cm.lo == cfg.d_ff
         and layer.tm_block is None and layer.cm_block is None,
         f"{tag}: the splits {layer.tm}, {layer.cm}, blocks {layer.tm_block}, "
         f"{layer.cm_block}")
    need(sharded["pos"] == TP_S + RNN_STEPS, f"{tag} pos {sharded['pos']}")
    need(torch.isfinite(got).all() and rec["logits_rel_err"] <= TP_BF16_TOL,
         f"{tag} logits {rec['logits_rel_err']}")
    need(all(f["margin"] <= f["max_abs_dlogit"] for f in flips),
         f"{tag}: tokens differ beyond a near-tie: {flips}")
    return rec


# (e): decode_32k's rows, the grid's one decode step from a seeded carried state
RWKV_GRID_DECODE_B = 128
RWKV_GRIDS = TP_GRIDS


def rwkv_grid_shares(cfg, grids):
    """(e) rwkv6-7b's layer 0 at full width (``norm1``, the time mix,
    ``norm2``, the channel mix, both residuals) under ``serve_2d`` on each
    grid of ``grids``, fp32 then the same weights in bf16: every rank at
    once, a thread a rank (``tensor_parallel.thread_shares``), each
    computing with its (embed block x model block) of the mixers' weights
    (the time mix's ``w_v``: its model block of rows x embed block of
    columns; ``decay_b`` gathered over ``data``), its WKV state's block on
    its heads and whole shifts. Two runs: a B 1 x S 2560 prefill and 4
    decode steps from the carried state, and one decode step of decode_32k's
    128 rows from a seeded carried state (fp32 WKV state, shifts in the
    activation dtype). Every rank's stream of every call against the
    unsplit layer's (``Block.prefill`` / ``decode``): fp32 within 1e-4 of
    the largest, bf16 within 5e-2 beside the unsplit bf16 layer's own error
    against fp32 (the partial products added in bf16, as a bf16 all-reduce
    adds them: the threads reduce in the tensors' dtype); each rank's WKV
    block against that block of the unsplit state and its shifts against
    the unsplit shifts; the ranks' streams bit-equal; one wkv6 launch a
    rank a call; wall ms of each run beside the unsplit run's."""
    lcfg = dataclasses.replace(cfg, n_layers=1)
    lm = init_params(lcfg, seed=SEED, device="cuda", dtype=torch.float32)
    block, model = lm.layers[0], build_model(lcfg)
    need(block.mixer == "rwkv", f"rwkv grid: layer 0 of {cfg.name} is {block.mixer}")
    rules = shd.STRATEGIES["serve_2d"]()
    H, K, B = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim, RWKV_GRID_DECODE_B
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    prompt = [torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")]
    prompt += [torch.randn(1, 1, cfg.d_model, generator=g, device="cuda")
               for _ in range(RWKV_DECODE)]
    step = [torch.randn(B, 1, cfg.d_model, generator=g, device="cuda")]
    carried = {"tm_shift": torch.randn(B, cfg.d_model, generator=g, device="cuda"),
               "wkv": torch.randn(B, H, K, K, generator=g, device="cuda"),
               "cm_shift": torch.randn(B, cfg.d_model, generator=g, device="cuda")}
    runs = {"prefill_and_decode": (1, prompt), "decode_32k_step": (B, step)}
    positions = torch.arange(TP_S, device="cuda")
    leaves = ("tm.w_r", "tm.w_v", "tm.decay_a", "tm.decay_b", "cm.w_k", "cm.w_r", "cm.w_v")

    def cache(rows, dtype):
        c = model.init_cache(rows, 1, dtype)
        if rows == B:  # the seeded carried state
            for k, t in carried.items():
                c["layers"][0][k].copy_(t)
        return c

    def calls(blk, xs, c, layer):
        return [blk.prefill(x, positions, c, layer) if x.shape[1] > 1
                else blk.decode(x, TP_S, c, layer) for x in xs]

    recs, unsplit32 = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        lm.to(dtype)
        for run, (rows, xs32) in runs.items():
            xs = [x.to(dtype) for x in xs32]
            want_c = cache(rows, dtype)["layers"][0]
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                want = calls(block, xs, want_c, None)
            torch.cuda.synchronize()
            want_ms, want_launches = (time.perf_counter() - t0) * 1e3, counts()
            unsplit32.setdefault(run, [w.float() for w in want])

            def one(blk, layer, c):
                outs = calls(blk, xs, c["layers"][0], layer)
                blocks = {n: list(getattr(getattr(blk, n[:2]), n[3:]).shape) for n in leaves}
                return outs, layer, blocks

            for grid in grids:
                n_ranks = grid["data"] * grid["model"]
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                with torch.no_grad():
                    got, caches = tp.thread_shares(lm, "layers", 0, grid, cache(rows, dtype),
                                                   one, rules)
                torch.cuda.synchronize()
                ms, launches = (time.perf_counter() - t0) * 1e3, counts()
                layer = got[0][1]
                state_err = max(rel_err(c["layers"][0]["wkv"],
                                        want_c["wkv"][:, lay.tm.lo:lay.tm.hi])
                                for (_, lay, _), c in zip(got, caches))
                shift_err = max(rel_err(c["layers"][0][k], want_c[k])
                                for c in caches for k in ("tm_shift", "cm_shift"))
                rec = {"case": f"{cfg.name} layer 0 (RWKV-6: {H} heads of {K}, d_ff "
                               f"{cfg.d_ff})", "strategy": "serve_2d", "grid": grid,
                       "run": run, "dtype": str(dtype)[6:], "rows": rows,
                       "calls": len(xs), "S": xs[0].shape[1],
                       "heads_a_rank": layer.tm.hi - layer.tm.lo,
                       "d_ff_a_rank": layer.cm.hi - layer.cm.lo,
                       "rank_blocks": got[0][2], "terms_added_in": str(dtype)[6:],
                       "rel_err": [max(rel_err(o[i], want[i]) for o, _, _ in got)
                                   for i in range(len(xs))],
                       "wkv_state_rel_err": state_err, "shift_rel_err": shift_err,
                       "tol": TP_FP32_TOL if dtype == torch.float32 else TP_BF16_TOL,
                       "ranks_equal": all(torch.equal(a, b) for o, _, _ in got
                                          for a, b in zip(o, got[0][0])),
                       "ms": ms, "unsplit_ms": want_ms, "launches": launches,
                       "launches_unsplit": want_launches}
                if dtype == torch.bfloat16:
                    rec["unsplit_vs_fp32"] = max(rel_err(a, b)
                                                 for a, b in zip(want, unsplit32[run]))
                    rec["shares_vs_fp32"] = max(rel_err(o[i], unsplit32[run][i])
                                                for o, _, _ in got for i in range(len(xs)))
                print("rwkv_grid_shares", json.dumps(rec), flush=True)
                tag = f"rwkv grid {grid} {run} ({dtype})"
                need(layer.tm_block is not None and layer.cm_block is not None
                     and layer.axis.split("layers.0.tm.w_v").dim == 0
                     and layer.axis.stationary("layers.0.tm.decay_b") is None
                     and rec["heads_a_rank"] == H // grid["model"],
                     f"{tag}: the blocks {rec['rank_blocks']}")
                need(launches == launch_counts(wkv=n_ranks * len(xs))
                     and want_launches == launch_counts(wkv=len(xs)),
                     f"{tag}: launches {launches}, unsplit {want_launches}")
                need(rec["ranks_equal"], f"{tag}: the ranks' streams differ")
                need(all(torch.isfinite(t.float()).all() for o, _, _ in got for t in o),
                     f"{tag}: non-finite")
                need(max(rec["rel_err"]) <= rec["tol"] and state_err <= rec["tol"]
                     and shift_err <= rec["tol"],
                     f"{tag}: streams {rec['rel_err']}, state {state_err}, shifts {shift_err}")
                recs.append(rec)
                del got, caches
            del want, want_c
    del lm, unsplit32
    torch.cuda.empty_cache()
    return recs


# (c): one layer, B 1 x S 256 (the WKV twin trains a Python loop a step);
# (d): 2 layers, B 2 x S 512, 2 AdamW steps
RWKV_TRAIN_S, RWKV_TRAIN_LAYERS, RWKV_TRAIN_B, RWKV_TRAIN_SEQ = 256, 2, 2, 512


def rwkv_train_shares(cfg, ranks):
    """(c) rwkv6-7b's layer 0 at full width in training (``norm1``, the time
    mix, ``norm2``, the channel mix, both residuals), B 1 x S 256, fp32 then
    bf16 cast from the same fp32 masters: for each W in ``ranks`` every
    rank's share in turn on its 64/W heads and 14336/W ``d_ff`` columns, in
    the plain form (``tensor_parallel.rwkv_shares`` without caches: every
    rank on the whole normed stream, the time mix's terms and the channel
    mix's value terms added in fp32) and in the sequence form
    (``tensor_parallel.seq_shares``: each rank normalizes its 256/W
    positions, the time mix's whole terms summed and sliced, the channel
    mix's products laid side by side and each rank's positions kept), one
    backward of <out, gy>: the output and the input's and every leaf's
    gradient (the whole-at-rest leaves' from their blocks, ``mu_*`` and
    ``decay_a``'s summed) against the unsplit ``Block.forward``'s; in bf16
    also each side against the fp32 unsplit layer. The WKV op trains
    through its chunked twin, on each rank's heads: no wkv6 launch."""
    lm = init_params(dataclasses.replace(cfg, n_layers=1), seed=SEED, device="cuda",
                     dtype=torch.float32)
    block = lm.layers[0]
    need(block.mixer == "rwkv", f"rwkv train shares: layer 0 of {cfg.name} is {block.mixer}")
    names = [n for n, _ in lm.named_parameters() if n.startswith("layers.0.")]
    masters = [lm.get_parameter(n).requires_grad_(True) for n in names]
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x32 = torch.randn(1, RWKV_TRAIN_S, cfg.d_model, generator=g, device="cuda")
    gy = torch.randn(1, RWKV_TRAIN_S, cfg.d_model, generator=g, device="cuda")
    positions = torch.arange(RWKV_TRAIN_S, device="cuda")
    H = cfg.d_model // cfg.rwkv_head_dim

    def grads(out, x):
        got = torch.autograd.grad((out.float() * gy).sum(), [x] + masters)
        return {"output": out.detach().float(), "input": got[0],
                **{n[len("layers.0."):]: gr for n, gr in zip(names, got[1:])}}

    recs, unsplit32 = [], None
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.clone().requires_grad_()
        reset_counts()
        with _reparametrize_module(lm, {n: t.to(dtype) for n, t in zip(names, masters)}):
            want = grads(block(x.to(dtype), positions)[0], x)
        want_launches = counts()
        if unsplit32 is None:
            unsplit32 = want
        for W, form in [(W, f) for W in ranks for f in ("plain", "sequence")]:
            shares = []
            for r in range(W):
                axis, params, _ = tp.share(lm, None, r, W,
                                           seq_len=RWKV_TRAIN_S if form == "sequence" else None)
                shares.append((axis, {n: params[n].to(dtype) for n in names}, None))
            x = x32.clone().requires_grad_()
            reset_counts()
            if form == "sequence":
                out, _ = tp.seq_shares(lm, 0, shares, x.to(dtype), positions)
            else:
                out = tp.rwkv_shares(lm, 0, shares, x.to(dtype))
            got = grads(out, x)
            torch.cuda.synchronize()
            launches = counts()
            axis, layer = shares[0][0], shares[0][0].layer(0)
            heads, ff = H // W, cfg.d_ff // W
            need(layer.tm_sum and layer.tm.hi - layer.tm.lo == heads and layer.cm_sum
                 and layer.cm.hi - layer.cm.lo == ff
                 and (axis.seq is not None) == (form == "sequence"),
                 f"rwkv train shares at {W} ({form}): the splits {layer.tm}, {layer.cm}, "
                 f"sequence {axis.seq}")
            err = {k: rel_err(got[k], want[k]) for k in want}
            worst = max((k for k in err if k != "output"), key=err.get)
            tol = (TP_FP32_TOL, TP_TRAIN_GRAD_TOL) if dtype == torch.float32 else \
                (TP_BF16_TOL, TP_BF16_TOL)
            rec = {"case": f"{cfg.name} layer 0 (RWKV-6: {H} heads of {cfg.rwkv_head_dim}, "
                           f"d_ff {cfg.d_ff}), training", "model_ranks": W, "form": form,
                   "dtype": str(dtype)[6:], "B": 1, "S": RWKV_TRAIN_S, "heads_a_rank": heads,
                   "d_ff_a_rank": ff, "terms_added_in": "float32",
                   "block_gradients": sorted(n[len("layers.0."):] for n in names
                                             if axis.split(n) is not None),
                   "summed_gradients": sorted(n[len("layers.0."):] for n in names
                                              if axis.sums_gradient(n)),
                   "rel_err": {"output": err["output"], "input": err["input"]},
                   "worst_gradient": worst, "worst_gradient_rel_err": err[worst],
                   "leaves": len(names), "tol": {"output": tol[0], "gradients": tol[1]},
                   "launches_shares": launches, "launches_unsplit": want_launches}
            if dtype == torch.bfloat16:
                for tag, side in (("unsplit_vs_fp32", want), ("shares_vs_fp32", got)):
                    e = {k: rel_err(side[k], unsplit32[k]) for k in unsplit32}
                    leaf = max((k for k in e if k != "output"), key=e.get)
                    rec[tag] = {"output": e["output"], "worst_gradient": e[leaf],
                                "worst_gradient_name": leaf}
            print("rwkv_split_train_shares", json.dumps(rec), flush=True)
            need(launches == launch_counts() and want_launches == launch_counts(),
                 f"rwkv train shares at {W} ({form}, {dtype}): launches {launches}")
            need(all(torch.isfinite(v.float()).all() for v in got.values()),
                 f"rwkv train shares at {W} ({form}): non-finite")
            need(err["output"] <= tol[0] and err[worst] <= tol[1],
                 f"rwkv train shares at {W} ({form}, {dtype}): output {err['output']}, "
                 f"{worst} {err[worst]}")
            recs.append(rec)
            del shares, got, out
        del want
    del lm, masters, unsplit32
    torch.cuda.empty_cache()
    return recs


def rwkv_train_path(cfg):
    """(d) rwkv6-7b at full width cut to 2 layers: 2 AdamW steps (bf16 over
    fp32 masters, remat "nothing", B 2 x S 512) through ``train_loop``,
    unsharded and on a 1-rank NCCL mesh under ``fsdp_tp`` (each layer on
    the training split's path with one block of all 64 heads and all 14336
    ``d_ff`` columns: the channel mix's reduce-scatter and gather, the sums
    into and out of the time mix, each the identity over one rank); the
    losses bit-equal, step ms of both sides, no wkv6 launch on either (the
    chunked twin trains)."""
    cfg = dataclasses.replace(cfg, n_layers=RWKV_TRAIN_LAYERS)
    meta = shapes.param_specs_shapes(cfg, torch.float32)
    layer = tp.ModelAxis({"data": 1, "model": 1}, shd.STRATEGIES["fsdp_tp"](),
                         tp.param_shapes(meta), None, tp.Shares(),
                         coord={"data": 0, "model": 0},
                         stream=(RWKV_TRAIN_B, RWKV_TRAIN_SEQ, cfg.d_model)).layer(0)
    unsharded, sharded = train_both_sides(cfg, RNN_TRAIN_STEPS, RWKV_TRAIN_B, RWKV_TRAIN_SEQ)
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": {"data": 1, "model": 1},
           "strategy": "fsdp_tp", "batch": RWKV_TRAIN_B, "seq": RWKV_TRAIN_SEQ,
           "steps": RNN_TRAIN_STEPS, "compute_dtype": "bfloat16", "master_dtype": "float32",
           "remat_policy": "nothing", "time_mix_heads": list(layer.tm),
           "channel_mix_d_ff": list(layer.cm), "unsharded": unsharded, "sharded": sharded,
           "bit_equal": sharded["losses"] == unsharded["losses"]}
    print("rwkv_split_train_path", json.dumps(rec), flush=True)
    need(layer.tm_sum and layer.tm.hi - layer.tm.lo == cfg.d_model // cfg.rwkv_head_dim
         and layer.cm_sum and layer.cm.hi - layer.cm.lo == cfg.d_ff,
         f"rwkv train path: the splits {layer.tm}, {layer.cm}")
    need(unsharded["launches"] == launch_counts() and sharded["launches"] == launch_counts(),
         f"rwkv train path launches {unsharded['launches']}, {sharded['launches']}")
    need(all(np.isfinite(unsharded["losses"])) and rec["bit_equal"],
         f"rwkv train path: sharded losses {sharded['losses']}, train_loop's "
         f"{unsharded['losses']}")
    return rec


def rwkv_split_phase():
    """(a) the shares of one full-width RWKV-6 layer at 8 and 16 ranks; (b)
    the 1-rank path's serving under ``fsdp_tp`` and ``serve_2d``; (c) the
    layer's training shares at 8 and 16 ranks; (d) the 1-rank path's
    training; (e) the layer under ``serve_2d`` on the (data x model)
    grids, every rank a thread."""
    cfg = get_config("rwkv6-7b")
    need((cfg.d_model, cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim, cfg.d_ff)
         == (4096, 64, 64, 14336), "rwkv6-7b width")
    paths = rwkv_path(cfg)
    return {"shares": rwkv_shares(cfg, (8, 16)), "path": paths["fsdp_tp"],
            "path_serve_2d": paths["serve_2d"],
            "train_shares": rwkv_train_shares(cfg, (8, 16)), "train_path": rwkv_train_path(cfg),
            "grid_shares": rwkv_grid_shares(cfg, RWKV_GRIDS)}


# ---------------------------------------------------------------------------
# Phase 8i: expert parallelism on the model axis
# ---------------------------------------------------------------------------

EP_STEPS, EP_MAX_LEN = 16, 4096  # moe_serve's engine: 16 new tokens, a 4096-slot cache
EP_TRAIN_S = 2048


def ep_replay(model, params, toks, fed, full, prefills):
    """A prefill of ``toks`` (``prefills`` times: cold, then warm), then one
    decode step on each column of ``fed``: every call's logits in fp32
    [1 + steps, B, 1, V], prefill ms, decode wall and device ms, launches."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    prefill_ms = []
    with torch.no_grad():
        for _ in range(prefills):
            cache = model.init_cache(toks.shape[0], EP_MAX_LEN, torch.bfloat16)
            reset_counts()
            start.record()
            logits, cache = model.prefill(params, {"tokens": toks}, cache)
            end.record()
            torch.cuda.synchronize()
            prefill_ms.append(start.elapsed_time(end))
            prefill_launches = counts()
        out = [full(logits).float()]
        reset_counts()
        t0 = time.perf_counter()
        start.record()
        for i in range(fed.shape[1]):
            logits, cache = model.decode_step(params, cache, fed[:, i:i + 1])
            out.append(full(logits).float())
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"logits": torch.stack(out), "prefill_ms": prefill_ms,
            "prefill_launches": prefill_launches, "decode_launches": counts(),
            "decode_ms_per_step": wall * 1e3 / fed.shape[1],
            "decode_device_ms_per_step": start.elapsed_time(end) / fed.shape[1],
            "pos": cache["pos"]}


def ep_path(state, moe, strategies=("fsdp_tp", "serve_2d")):
    """(b) moe_serve's weights sharded in place on a 1-rank NCCL mesh,
    through ``ShardedModel`` under each of ``strategies``' rules (each MoE
    layer on the expert split's path, one block of all 128 experts; decode
    attention over the cache's one sequence shard, which holds every
    position: the plain path, as one process's; under ``serve_2d`` no
    ``embed`` block stays, the ``data`` axis holding one rank): a prefill of
    moe_serve's padded prompts cold then warm, then 16 decode steps fed
    moe_serve's greedy tokens, first through the unsharded model (whose
    greedy choices must be moe_serve's), then sharded. Each call's logits
    are held to the unsharded ones within TP_BF16_TOL of the largest: one
    bf16 rounding apart passes, a wrong mask or merge parts them by a third.
    The sharded argmax is compared with moe_serve's tokens and every flip is
    reported with the unsharded top-2 margin there: a near-tie the bf16
    logits' difference can flip. -> the records by strategy."""
    cfg, params, toks = state["cfg"], state["params"], state["tokens"].cuda()
    want_toks = state["outputs"]
    fed = want_toks.cuda()
    plain = ep_replay(build_model(cfg), params, toks, fed, lambda t: t, 1)
    want = plain["logits"]
    steps = want_toks.shape[1]
    plain_toks = want[:steps, :, 0].argmax(-1).T.cpu()
    top2 = want[:steps, :, 0].topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).T.cpu()
    recs = {}
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        # in place: each weight a DTensor over the one rank
        ShardedModel(build_model(cfg), mesh, shd.STRATEGIES[strategies[0]]()).shard(params)
        for strategy in strategies:
            model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES[strategy]())
            cache = model.init_cache(toks.shape[0], EP_MAX_LEN, torch.bfloat16)
            layer = model.model_axis(params, cache, (), 1, stationary=True).layer(0)
            del cache
            sharded = ep_replay(model, params, toks, fed, lambda t: t.full_tensor(), 2)
            recs[strategy] = ep_path_record(cfg, toks, want_toks, plain, sharded, layer,
                                            strategy, moe, margin, plain_toks)
    first, second = (recs[s] for s in strategies)
    second[f"{strategies[0]}_decode_ms_per_step"] = first["decode_ms_per_step"]
    second[f"tokens_equal_{strategies[0]}"] = second["argmax"] == first["argmax"]
    for rec in recs.values():
        print("ep_serve_path", json.dumps(rec), flush=True)
    need(second[f"tokens_equal_{strategies[0]}"],
         f"ep {strategies[1]}: its tokens differ from {strategies[0]}'s on one rank")
    return recs


def ep_path_record(cfg, toks, want_toks, plain, sharded, layer, strategy, moe, margin,
                   plain_toks):
    """One strategy's ``ep_path`` record and its checks."""
    want, got = plain["logits"], sharded["logits"]
    steps = want_toks.shape[1]
    got_toks = got[:steps, :, 0].argmax(-1).T.cpu()
    diff = (got - want).abs().amax(dim=(1, 2, 3)).cpu()
    flips = [{"row": r, "step": i, "margin": float(margin[r, i]), "max_abs_dlogit": float(diff[i])}
             for r, i in torch.nonzero(got_toks != want_toks).tolist()]
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": {"data": 1, "model": 1},
           "strategy": strategy, "batch": toks.shape[0], "prefill_len": toks.shape[1],
           "experts_split": list(layer.experts), "cache_seq_split": list(layer.seq),
           "prefill_ms_cold": sharded["prefill_ms"][0], "prefill_ms": sharded["prefill_ms"][1],
           "moe_serve_prefill_ms": moe["prefill_ms"],
           "decode_ms_per_step": sharded["decode_ms_per_step"],
           "decode_device_ms_per_step": sharded["decode_device_ms_per_step"],
           "unsharded_decode_ms_per_step": plain["decode_ms_per_step"],
           "moe_serve_decode_ms_per_step": moe["decode_ms_per_step"],
           "unsharded_tokens_equal_moe_serve": bool(torch.equal(plain_toks, want_toks)),
           "prefill_logits_equal": bool(torch.equal(got[0], want[0])),
           "logits_rel_err": [rel_err(g, w) for g, w in zip(got, want)],
           "logits_max_abs": float(want.abs().max()), "logits_tol": TP_BF16_TOL,
           "tokens_equal": int((got_toks == want_toks).sum()), "tokens": want_toks.numel(),
           "flips": flips, "argmax": got_toks.tolist(),
           "moe_block_stays": layer.moe_block is not None,
           "launches_per_prefill": sharded["prefill_launches"],
           "launches_decode": sharded["decode_launches"]}
    need(layer.experts is not None and layer.experts.dim == 0,
         f"ep {strategy}: experts not split ({layer.experts})")
    need(layer.moe_block is None, f"ep {strategy}: an embed block {layer.moe_block} stays "
                                  "on a 1-rank data axis")
    need(layer.seq is not None, f"ep {strategy}: the cache's sequence does not lie over model")
    need(sharded["prefill_launches"] == launch_counts(flash_wgmma=cfg.n_layers),
         f"ep {strategy} prefill launches {sharded['prefill_launches']}")
    need(sharded["decode_launches"] == launch_counts(), f"ep {strategy} decode launched "
                                                        f"{sharded['decode_launches']}")
    need(sharded["pos"] == toks.shape[1] + steps, f"ep {strategy} pos {sharded['pos']}")
    need(rec["unsharded_tokens_equal_moe_serve"],
         f"ep: the unsharded replay's tokens {plain_toks[:, :8].tolist()} differ from "
         f"moe_serve's {want_toks[:, :8].tolist()}")
    need(torch.isfinite(got).all() and max(rec["logits_rel_err"]) <= TP_BF16_TOL,
         f"ep {strategy} logits {rec['logits_rel_err']}")
    return rec


def ep_grads(out, aux, gy, x, leaves, names):
    """The gradients of <out, gy> (the input's and every leaf's) and of the
    aux term (the input's and the router's: it reaches no expert), by name."""
    g = torch.autograd.grad((out.float() * gy).sum(), [x] + leaves, retain_graph=True)
    router = names.index("router")
    ga = torch.autograd.grad(aux, [x, leaves[router]])
    return {"input": g[0], **dict(zip(names, g[1:])), "aux:input": ga[0], "aux:router": ga[1]}


def ep_shares(cfg, ranks):
    """(a) one full-width MoE block of ``cfg``, fp32 then the same weights in
    bf16, B 1 x S 2560: for each W in ``ranks`` every rank's share in turn
    through ``LayerAxis.moe`` over ``Shares`` (its expert blocks, or where W
    does not divide E every expert's ff columns, the tokens routed whole),
    the sums over ``model`` applied here, a backward of <out, gy> and one of
    the ranks' aux terms (each one's gradient 1/W of the whole; apart, since
    beside the gates' it would be lost): the output and the input's and
    every leaf's gradient of each against the unsplit block's. The ff split
    runs forward only: its gates' gradient is summed over ``model`` before
    its bf16 rounding, which a share alone cannot do. Each rank's blocks are cast from fp32 masters and its input
    from an fp32 copy, so the terms of every sum, forward and backward, add
    in fp32."""
    moe = MoE(cfg, "cuda", torch.float32)
    moe.reset_parameters(torch.Generator(device="cuda").manual_seed(SEED))
    names = [n for n, _ in moe.named_parameters()]
    shapes = {f"layers.0.moe.{n}": tuple(p.shape) for n, p in moe.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x32 = torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")
    gy = torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda")
    route = moe._route(x32.view(-1, cfg.d_model), 256)
    per_expert = route.n_slots // cfg.n_experts  # G * C
    recs, unsplit32 = [], None
    for dtype in (torch.float32, torch.bfloat16):
        moe.to(dtype).requires_grad_(True)
        x = x32.to(dtype).requires_grad_()
        out, aux = moe(x)
        want = {"output": out.detach(), **ep_grads(out, aux, gy, x, list(moe.parameters()),
                                                   names)}
        del out
        if unsplit32 is None:
            unsplit32 = want
        masters = {n: p.detach().float().requires_grad_() for n, p in moe.named_parameters()}
        for W in ranks:
            xm = x32.clone().requires_grad_()
            outs, auxs, blocks_of = [], [], []
            for r in range(W):
                axis = tp.ModelAxis({"model": W}, shd.STRATEGIES["fsdp_tp"](), shapes, None,
                                    tp.Shares(), coord={"model": r})
                layer = axis.layer(0)
                need(layer.moe_sum, f"{cfg.name} at {W}: no split")
                form = "experts" if layer.experts.dim == 0 else "ff"
                blocks = {}
                for n in names:
                    sp = axis.split(f"layers.0.moe.{n}")
                    t = masters[n] if sp is None else masters[n].narrow(sp.dim, sp.lo,
                                                                        sp.hi - sp.lo)
                    blocks[n] = t.to(dtype)
                # the ff split's forward only: a share alone cannot sum its gates'
                # gradient over model before the bf16 rounding (it raises)
                with _reparametrize_module(moe, blocks), \
                        torch.set_grad_enabled(form == "experts"):
                    o, a = layer.moe(moe, xm.to(dtype), with_aux=True)
                outs.append(o)
                auxs.append(a)
                blocks_of.append(blocks["w_up"].shape[layer.experts.dim])
            got_out = sum(o.float() for o in outs)
            got = {"output": got_out}
            if form == "experts":
                got.update(ep_grads(got_out, sum(auxs), gy, xm, [masters[n] for n in names],
                                    names))
            torch.cuda.synchronize()
            need(set(blocks_of) == {(cfg.n_experts if form == "experts" else cfg.d_ff) // W},
                 f"{cfg.name} at {W}: {form} blocks {blocks_of}")
            err = {k: rel_err(got[k], want[k]) for k in got}
            worst = max((k for k in err if k != "output"), key=err.get, default="output")
            tol = (TP_FP32_TOL, TP_TRAIN_GRAD_TOL) if dtype == torch.float32 else \
                (TP_BF16_TOL, TP_BF16_TOL)
            rec = {"case": f"{cfg.name} MoE block ({cfg.n_experts} experts top-"
                           f"{cfg.experts_per_token}, d {cfg.d_model}, ff {cfg.d_ff})",
                   "model_ranks": W, "form": form, "backward": form == "experts",
                   "dtype": str(dtype)[6:], "B": 1, "S": TP_S, "terms_added_in": "float32",
                   "slot_rows_a_rank": [cfg.n_experts // W if form == "experts" else
                                        cfg.n_experts, per_expert],
                   "ff_columns_a_rank": cfg.d_ff if form == "experts" else cfg.d_ff // W,
                   "slot_rows_whole": [cfg.n_experts, per_expert],
                   "aux_equal": all(float(a) == float(aux) for a in auxs),
                   "rel_err": err, "worst_gradient": worst,
                   "tol": {"output": tol[0], "gradients": tol[1]},
                   "summed_gradients": sorted(n for n in names
                                              if axis.sums_gradient(f"layers.0.moe.{n}"))}
            if dtype == torch.bfloat16:
                rec["unsplit_vs_fp32"] = {k: rel_err(want[k], unsplit32[k]) for k in got}
                rec["shares_vs_fp32"] = {k: rel_err(got[k], unsplit32[k]) for k in got}
            print("ep_shares", json.dumps(rec), flush=True)
            need(all(torch.isfinite(v.float()).all() for v in got.values()),
                 f"ep shares {cfg.name} at {W}: non-finite")
            need(rec["aux_equal"] and rec["summed_gradients"] == ["router"],
                 f"ep shares {cfg.name} at {W}: aux {rec['aux_equal']}, "
                 f"summed {rec['summed_gradients']}")
            need(err["output"] <= tol[0] and err[worst] <= tol[1],
                 f"ep shares {cfg.name} at {W} ({dtype}): output {err['output']}, "
                 f"{worst} {err[worst]}")
            recs.append(rec)
            del outs, auxs, got, got_out
        del want, masters
    del moe, unsplit32
    torch.cuda.empty_cache()
    return recs


# serve_2d's (data x model) grids for one full-width MoE block, as tp_grid_shares';
# a decode-shaped call of decode_32k's 128 rows; fp32 within 1e-5 of the largest
EP_GRIDS = TP_GRIDS
EP_GRID_DECODE_B, EP_GRID_FP32_TOL = 128, 1e-5


def record_routes(moe):
    """Each call's (route, router logits) of ``moe`` (``MoE._route``'s and
    ``MoE._logits``'), kept as the calls make them, until ``del moe._route,
    moe._logits``."""
    calls = []
    route, logits = type(moe)._route, type(moe)._logits

    def recorded(*a, **k):  # the logits are recorded inside, into the new entry
        calls.append([])
        calls[-1].insert(0, route(moe, *a, **k))
        return calls[-1][0]

    moe._route = recorded
    moe._logits = lambda *a, **k: calls[-1].append(logits(moe, *a, **k)) or calls[-1][-1]
    return calls


def choices(logits, k):
    """The k experts each token chooses, in order, as ``MoE._route`` sorts
    its probabilities."""
    probs = torch.softmax(logits, dim=-1)
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]


def route_flips(route, want_route, logits, want_logits, k):
    """Tokens whose k choices (in order) differ from the unsplit route's,
    each with the unsplit logits' least gap among its top k + 1 (the
    nearest tie) and the largest difference of the rank's summed logits from
    the unsplit ones there; the count of tokens whose choices agree but
    whose drops differ (a flip elsewhere in the queue moved them); the
    tokens whose choices and drops agree but one of whose gates rounds to
    another bf16 value (``moe.bf16_gates``: an fp32 gate a rounding step's
    half from a bf16 boundary), each with its fp32 gates and their largest
    difference; and the masks of the tokens routed alike (choices and
    drops) and of those routed and gated alike."""
    top_idx, want_idx = choices(logits, k), choices(want_logits, k)
    chose = (top_idx == want_idx).all(-1)
    dropped = (route.keep != want_route.keep).any(-1) & chose
    gates, want_gates = (bf16_gates(r.top_vals, torch.float32) for r in (route, want_route))
    rounded = (gates != want_gates).any(-1) & chose & ~dropped
    top = want_logits.topk(k + 1, dim=-1).values
    gap = (top[:, :-1] - top[:, 1:]).min(-1).values
    dz = (logits - want_logits).abs().amax(-1)
    flips = [{"token": t, "margin": float(gap[t]), "max_abs_dlogit": float(dz[t]),
              "choices": top_idx[t].tolist(), "unsplit_choices": want_idx[t].tolist()}
             for t in torch.nonzero(~chose).flatten().tolist()]
    dv = (route.top_vals - want_route.top_vals).abs().amax(-1)
    gate_steps = [{"token": t, "dgate_fp32": float(dv[t]),
                   "gates_fp32": route.top_vals[t].tolist(),
                   "unsplit_gates_fp32": want_route.top_vals[t].tolist(),
                   "gates_bf16": gates[t].tolist(), "unsplit_gates_bf16": want_gates[t].tolist()}
                  for t in torch.nonzero(rounded).flatten().tolist()]
    return flips, int(dropped.sum()), gate_steps, chose & ~dropped, chose & ~dropped & ~rounded


def ep_grid_shares(cfg, grids):
    """(d) one full-width MoE block of ``cfg`` under ``serve_2d`` on each grid
    of ``grids``, fp32 then the same weights in bf16: every rank at once, a
    thread a rank (``tensor_parallel.ThreadRanks``), through
    ``LayerAxis.moe`` with its (experts x embed block) of each expert leaf
    and its embed block of the router, on a B 1 x S 2560 prefill and a B 128
    x 1 decode-shaped call (decode_32k's rows). Each call's router logits
    (``MoE._logits``: on a rank, its columns times its router block, summed
    over ``data``) and route are recorded. Each rank's output
    against the unsplit block's on the tokens routed and gated alike
    (fp32 within 1e-5 of its largest; bf16 within 5e-2, beside the unsplit
    bf16 block's own error against fp32; the whole output's error beside
    it), the ranks' outputs bit-equal, each rank's routing (choices, drops,
    slots) equal to the unsplit block's in fp32, in bf16 the flipped tokens
    with their margins; the tokens one of whose gates rounds to another
    bf16 value (the gates pass through bf16 also in fp32: an fp32 gate
    within the logits' rounding of a bf16 boundary), each with its fp32
    gates, which must lie within the tolerance of the unsplit ones; the
    wall ms of each grid call (cold, warm) beside the unsplit call's ms
    under CUDA events; no kernel launches."""
    moe = MoE(cfg, "cuda", torch.float32)
    moe.reset_parameters(torch.Generator(device="cuda").manual_seed(SEED))
    names = [n for n, _ in moe.named_parameters()]
    shapes = {f"layers.0.moe.{n}": tuple(p.shape) for n, p in moe.named_parameters()}
    rules = shd.STRATEGIES["serve_2d"]()
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    inputs = {"prefill": torch.randn(1, TP_S, cfg.d_model, generator=g, device="cuda"),
              "decode": torch.randn(EP_GRID_DECODE_B, 1, cfg.d_model, generator=g,
                                    device="cuda")}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    recs, unsplit32 = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        moe.to(dtype).requires_grad_(False)
        for when, x32 in inputs.items():
            x = x32.to(dtype)
            xt = x.view(-1, cfg.d_model)
            with torch.no_grad():
                calls = record_routes(moe)
                start.record()
                want = moe(x)[0]
                end.record()
                torch.cuda.synchronize()
                del moe._route, moe._logits
                (want_route, want_logits), want_ms = calls[0], start.elapsed_time(end)
            unsplit32.setdefault(when, want.float())
            for grid in grids:
                ranks = tp.ThreadRanks(grid)
                made = []
                for r in range(ranks.size):
                    axis = tp.ModelAxis(grid, rules, shapes, None, ranks.rank(r),
                                        coord=ranks.coordinate(r), weight_stationary=True)
                    blocks = {}
                    for n in names:
                        t = getattr(moe, n)
                        for sp in (axis.split(f"layers.0.moe.{n}"),
                                   axis.stationary(f"layers.0.moe.{n}")):
                            if sp is not None:
                                t = t.narrow(sp.dim, sp.lo, sp.hi - sp.lo)
                        blocks[n] = t
                    # the rank's module: the block's structure, its weights on meta
                    empty = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                                       False) for p in moe.parameters()}
                    made.append((axis, blocks, copy.deepcopy(moe, empty)))

                def one(r):
                    axis, blocks, module = made[r]
                    calls = record_routes(module)
                    with torch.no_grad(), _reparametrize_module(module, blocks):
                        out = axis.layer(0).moe(module, x)
                    route, logits = calls[0]
                    return out, logits, route

                ms = []
                for _ in range(2):  # cold, then warm
                    torch.cuda.synchronize()
                    reset_counts()
                    t0 = time.perf_counter()
                    outs = ranks.run(one)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    launches = counts()
                got, logits, route = outs[0]
                layer = made[0][0].layer(0)
                flips, drops_moved, gate_steps, routed, gated = route_flips(
                    route, want_route, logits, want_logits, cfg.experts_per_token)
                agree = gated if dtype == torch.float32 else routed
                need(bool(agree.any()), f"{cfg.name} {grid} {when}: no token routed alike")
                rec = {"case": f"{cfg.name} MoE block ({cfg.n_experts} experts top-"
                               f"{cfg.experts_per_token}, d {cfg.d_model}, ff {cfg.d_ff})",
                       "strategy": "serve_2d", "grid": grid, "call": when,
                       "dtype": str(dtype)[6:], "rows": list(x.shape[:2]),
                       "form": "experts" if layer.experts.dim == 0 else "ff",
                       "rank_blocks": {n: list(made[0][1][n].shape) for n in names},
                       "router_terms_added_in": str(dtype)[6:],
                       "rel_err": rel_err(got, want),
                       "rel_err_agreeing_tokens": rel_err(got.view(-1, cfg.d_model)[agree],
                                                          want.view(-1, cfg.d_model)[agree]),
                       "logits_rel_err": rel_err(logits, want_logits),
                       "tol": EP_GRID_FP32_TOL if dtype == torch.float32 else TP_BF16_TOL,
                       "ranks_equal": all(torch.equal(o, got) and torch.equal(z, logits)
                                          for o, z, _ in outs),
                       "ranks_route_equal": all(
                           torch.equal(rt.keep, route.keep) and torch.equal(rt.slot, route.slot)
                           for _, _, rt in outs),
                       "route_equal": {
                           "top_idx": bool(torch.equal(choices(logits, cfg.experts_per_token),
                                                       choices(want_logits,
                                                               cfg.experts_per_token))),
                           **{k: bool(torch.equal(getattr(route, k), getattr(want_route, k)))
                              for k in ("keep", "slot")}},
                       "agreeing": "routed and gated alike" if dtype == torch.float32
                                   else "routed alike",
                       "tokens": int(xt.shape[0]), "tokens_agreeing": int(agree.sum()),
                       "tokens_routed_alike": int(routed.sum()),
                       "tokens_routed_and_gated_alike": int(gated.sum()),
                       "flips": flips, "flip_count": len(flips),
                       "flip_max_margin": max((f["margin"] for f in flips), default=0.0),
                       "drops_moved": drops_moved,
                       "flip_margin_over_dlogit": max(
                           (f["margin"] / max(f["max_abs_dlogit"], 1e-30) for f in flips),
                           default=0.0),
                       "gate_steps": {"count": len(gate_steps), "first": gate_steps[:4],
                                      "max_dgate_fp32": max((g["dgate_fp32"] for g in gate_steps),
                                                            default=0.0)},
                       "ms_cold": ms[0], "ms": ms[1], "unsplit_ms": want_ms,
                       "launches": launches}
                if dtype == torch.bfloat16:
                    rec["unsplit_vs_fp32"] = rel_err(want, unsplit32[when])
                    rec["shares_vs_fp32"] = rel_err(got, unsplit32[when])
                # every flip in chip_smoke.json; the line shows the first few
                print("ep_grid_shares", json.dumps({**rec, "flips": flips[:4]}), flush=True)
                tag = f"ep grid {cfg.name} {grid} {when} ({dtype})"
                need(made[0][0].stationary("layers.0.moe.w_up") is not None
                     and made[0][0].stationary("layers.0.moe.router") is not None,
                     f"{tag}: no embed block stays")
                need(launches == launch_counts(), f"{tag}: launches {launches}")
                need(rec["ranks_equal"] and rec["ranks_route_equal"],
                     f"{tag}: the ranks' outputs or routes differ")
                need(all(torch.isfinite(o).all() for o, _, _ in outs), f"{tag}: non-finite")
                need(rec["logits_rel_err"] <= rec["tol"], f"{tag}: router logits "
                                                          f"{rec['logits_rel_err']}")
                # a gate another bf16 step away only where its fp32 value moved by
                # the logits' rounding: within the tolerance of the largest gate
                need(all(g["dgate_fp32"] <= rec["tol"] for g in gate_steps),
                     f"{tag}: gates moved {gate_steps}")
                if dtype == torch.float32:
                    need(all(rec["route_equal"].values())
                         and rec["rel_err_agreeing_tokens"] <= rec["tol"],
                         f"{tag}: route {rec['route_equal']}, output "
                         f"{rec['rel_err_agreeing_tokens']}")
                else:
                    need(rec["rel_err_agreeing_tokens"] <= rec["tol"]
                         and (drops_moved == 0 or flips),
                         f"{tag}: output {rec['rel_err_agreeing_tokens']}, "
                         f"{drops_moved} drops moved with {len(flips)} flips")
                recs.append(rec)
                del outs, made, got, logits
    del moe
    torch.cuda.empty_cache()
    return recs


def ep_train_path():
    """(c) phi3.5-moe-42b-a6.6b at full width, 1 layer (16 experts top-2),
    bf16 over fp32 masters, remat "nothing", B 1 x S 2048, 3 AdamW steps:
    ``train_loop`` unsharded, then the same seeded weights and batches through
    ``ShardedModel`` on a 1-rank NCCL mesh (the expert split's path, one
    block of all 16 experts); losses, step ms, peak memory, flash launches."""
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), n_layers=1)
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1),
                         total_steps=TP_TRAIN_STEPS, warmup_steps=1, remat_policy="nothing",
                         compute_dtype=torch.bfloat16)
    data = SyntheticLM(DataConfig(cfg.vocab_size, EP_TRAIN_S, 1, seed=SEED))
    batches = [data.batch(i) for i in range(TP_TRAIN_STEPS)]

    def train(model, lm):
        events = []
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        lm, state, hist = train_loop(model, lm, timed_batches(batches, events), run,
                                     log_every=1)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        events.append(end)
        return {"losses": [h["loss"] for h in hist], "launches": counts(),
                "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    model = build_model(cfg)
    lm = model.init(SEED, torch.float32)
    n_params = sum(p.numel() for p in lm.parameters())
    unsharded = train(model, lm)
    del lm
    torch.cuda.empty_cache()
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        model = ShardedModel(build_model(cfg), mesh, shd.STRATEGIES["fsdp_tp"]())
        lm = model.init(SEED, torch.float32)
        experts = model.model_axis(lm, None, (), 1).layer(0).experts
        sharded = train(model, lm)
        del lm
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(sharded["losses"], unsharded["losses"])]
    per_step = launch_counts(flash_wgmma=2)
    rec = {"arch": cfg.name, "layers": 1, "params": n_params, "batch": 1, "seq": EP_TRAIN_S,
           "steps": TP_TRAIN_STEPS, "compute_dtype": "bfloat16", "master_dtype": "float32",
           "remat_policy": "nothing", "mesh": {"data": 1, "model": 1}, "strategy": "fsdp_tp",
           "experts_split": None if experts is None else list(experts),
           "unsharded": unsharded, "sharded": sharded, "loss_max_rel_err": max(rel),
           "loss_tol": TP_TRAIN_LOSS_RTOL, "launches_per_step_expected": per_step,
           "step_ms_median_warm": {k: float(np.median(r["step_ms"][1:]))
                                   for k, r in (("unsharded", unsharded),
                                                ("sharded", sharded))}}
    print("ep_train_path", json.dumps(rec), flush=True)
    want = {k: v * TP_TRAIN_STEPS for k, v in per_step.items()}
    need(experts is not None and experts.dim == 0, f"ep train: experts not split ({experts})")
    need(unsharded["launches"] == want and sharded["launches"] == want,
         f"ep train launches {unsharded['launches']}, {sharded['launches']}; expected {want}")
    need(all(np.isfinite(sharded["losses"])) and max(rel) <= TP_TRAIN_LOSS_RTOL,
         f"ep train: sharded losses {sharded['losses']} against {unsharded['losses']}")
    return rec


def ep_phase(moe, state):
    paths = ep_path(state, moe)
    rec = {"path": paths["fsdp_tp"], "path_serve_2d": paths["serve_2d"]}
    state.clear()  # moe_serve's weights
    torch.cuda.empty_cache()
    qwen, phi = get_config("qwen3-moe-235b-a22b"), get_config("phi3.5-moe-42b-a6.6b")
    need((phi.n_experts, phi.experts_per_token, phi.d_model, phi.d_ff) == (16, 2, 4096, 6400),
         "phi3.5-moe width")
    rec["shares"] = ep_shares(qwen, (8, 16)) + ep_shares(phi, (16, 32))
    t0 = time.perf_counter()
    rec["grid_shares"] = ep_grid_shares(qwen, EP_GRIDS) + ep_grid_shares(phi, EP_GRIDS)
    rec["grid_seconds"] = time.perf_counter() - t0
    rec["train"] = ep_train_path()
    return rec


# ---------------------------------------------------------------------------
# Phases 9-11: training
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 2560


def timed_batches(batches, events):
    """Yield ``batches``, recording a CUDA event on the stream as each is
    taken: the events bracket each step the loop runs."""
    for batch in batches:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        yield batch


def train_phase():
    """recurrentgemma-9b at full width, depth cut to one pattern group of 3
    layers: 4 steps of ``train_loop`` (bf16 compute over fp32 masters, remat
    "nothing") and one more with grad_accum=2, B 2 x S 2560."""
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=3)
    need(cfg.n_groups_and_tail() == (1, 0), "train: one pattern group, no tail")
    model = build_model(cfg)
    lm = model.init(SEED, torch.float32)
    n_params = sum(p.numel() for p in lm.parameters())
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED))
    batches = [data.batch(i) for i in range(5)]  # set-up, not timed
    before = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    run = TrainRunConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1), total_steps=5,
                         warmup_steps=1, remat_policy="nothing",
                         compute_dtype=torch.bfloat16)
    events = []
    reset_counts()
    lm, state, hist = train_loop(model, lm, timed_batches(batches[:4], events), run,
                                 log_every=1)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    launches = counts()
    # per step: the flash forward, again in the group's recompute (its backward
    # recomputes plainly); the scan forward, recompute and backward, 2 layers
    need(launches == launch_counts(flash_wgmma=4 * 2, rglru=4 * 6),
         f"train launches {launches}")
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    accum_events = []
    reset_counts()
    lm, state, accum_hist = train_loop(
        model, lm, timed_batches(batches[4:], accum_events),
        dataclasses.replace(run, grad_accum=2), log_every=1, opt_state=state, start_step=4)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    accum_launches = counts()
    need(accum_launches == launch_counts(flash_wgmma=2 * 2, rglru=2 * 6),
         f"train grad_accum=2 launches {accum_launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist + accum_hist]
    need(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    need(state.step == 5, f"train: optimizer step {state.step}, expected 5")
    unmoved = [n for n, p in lm.named_parameters() if torch.equal(p.detach().cpu(), before[n])]
    need(not unmoved, f"train: parameters that did not move: {unmoved}")
    median_ms = float(np.median(step_ms[1:]))
    # model FLOPs of a step: 6 N per token for the matrix products (the tied
    # embedding counted once, as the head's product), and the attention
    # layer's QK^T and PV, 4 D Hq per visible (query, key) pair forward and
    # twice that backward; remat's recompute is not model work
    pairs = fa_ops.visible_pairs(TRAIN_S, TRAIN_S, True, cfg.window)
    n_attn = 1
    dense = 6 * n_params * TRAIN_B * TRAIN_S
    attn = 3 * 4 * cfg.head_dim * cfg.n_heads * pairs * TRAIN_B * n_attn
    flops = dense + attn
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "compute_dtype": "bfloat16", "master_dtype": "float32",
           "remat_policy": run.remat_policy, "batch": TRAIN_B, "seq": TRAIN_S,
           "losses": losses, "opt_step": state.step, "step_ms": step_ms,
           "step_ms_median_after_first": median_ms,
           "grad_accum2_step_ms": accum_events[0].elapsed_time(end),
           "tok_per_s": TRAIN_B * TRAIN_S / (median_ms * 1e-3),
           "peak_mem_gib": peak, "launches_per_4_steps": launches,
           "launches_grad_accum2_step": accum_launches,
           "model_flops_per_step": flops,
           "model_flops_count": f"6 * {n_params} params * {TRAIN_B * TRAIN_S} tokens + "
                                f"12 * D {cfg.head_dim} * Hq {cfg.n_heads} * {pairs} pairs "
                                f"* B {TRAIN_B} * {n_attn} attention layer",
           "model_flops_share_of_bf16_peak":
               flops / (median_ms * 1e-3) / roofline.PEAK_OPS_PER_S[torch.bfloat16]}
    print("train", json.dumps(rec), flush=True)
    return rec


def train_check_phase(arch, n_layers, B, S, expect, loss_tol, grad_tol, remat_policy=None):
    """Full width, depth cut to ``n_layers``, fp32 (TF32 off): the loss and
    every parameter's gradient on the card (kernels) against the same
    weights and batch on the CPU (plain twins). No remat unless asked: the
    CPU tests hold every remat policy to the gradients of none. An MoE
    config also compares ``moe_aux`` (within ``loss_tol``) and reports its
    routers' worst gradient."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    lm = init_params(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=SEED)).batch(0)

    def loss_and_grads(lm, dev):
        lm.requires_grad_(True)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, metrics = lm_loss(lm, tb, remat_policy=remat_policy)
        names, params = zip(*lm.named_parameters())
        grads = torch.autograd.grad(loss, params)
        return (float(loss.detach()), float(metrics["moe_aux"].detach()),
                {n: g.cpu() for n, g in zip(names, grads)})

    # WKV's training route: the chunked twin, called once a layer (counted by
    # wrapping it for the card's run)
    chunked, calls = wkv_ref.wkv6_chunked, []
    wkv_ref.wkv6_chunked = lambda *a, **kw: calls.append(1) or chunked(*a, **kw)
    reset_counts()
    try:
        loss, aux, grads = loss_and_grads(lm, torch.device("cuda"))
        torch.cuda.synchronize()
    finally:
        wkv_ref.wkv6_chunked = chunked
    launches = counts()
    need(launches == expect, f"{arch} train check launches {launches}, expected {expect}")
    n_rwkv = sum(layer.mixer == "rwkv" for layer in lm.layers)
    need(len(calls) == n_rwkv, f"{arch}: {len(calls)} chunked WKV calls, expected {n_rwkv}")
    cpu_lm = LM(cfg, torch.device("cpu"), torch.float32)
    cpu_lm.load_state_dict(lm.state_dict())
    del lm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_loss, cpu_aux, cpu_grads = loss_and_grads(cpu_lm, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    rel = {n: float((grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
           for n, g in cpu_grads.items()}
    worst = max(rel, key=rel.get)
    rec = {"arch": cfg.name, "layers": n_layers, "dtype": "float32", "batch": B, "seq": S,
           "loss": loss, "cpu_loss": cpu_loss, "loss_abs_err": abs(loss - cpu_loss),
           "loss_tol": loss_tol, "worst_leaf": worst, "worst_leaf_rel_err": rel[worst],
           "grad_tol": f"{grad_tol} * max|g| per leaf", "leaves": len(rel),
           "launches": launches, "wkv6_chunked_calls": len(calls), "cpu_s": cpu_s,
           "remat_policy": remat_policy}
    if cfg.is_moe:
        routers = [n for n in rel if n.endswith("moe.router")]
        need(len(routers) == n_layers, f"{arch}: router gradients {routers}")
        rec.update(moe_aux=aux, cpu_moe_aux=cpu_aux, moe_aux_abs_err=abs(aux - cpu_aux),
                   router_rel_err=max(rel[n] for n in routers))
        need(abs(aux - cpu_aux) <= loss_tol, f"{arch}: card vs CPU moe_aux {aux} vs {cpu_aux}")
    print("train_check", json.dumps(rec), flush=True)
    need(np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()),
         f"{arch} train check: non-finite loss or gradient")
    need(abs(loss - cpu_loss) <= loss_tol, f"{arch}: card vs CPU loss {loss} vs {cpu_loss}")
    need(rel[worst] <= grad_tol, f"{arch}: gradient of {worst} off by {rel[worst]}")
    return rec


def train_lm_phase():
    """``python -m repro_torch.launch.train_lm --steps 60``: nemo-100m in
    fp32 (head_dim 64: the CUDA-core flash kernel), 8 layers each its own
    remat group, so 2 flash launches a layer a step."""
    ckpt = ROOT / "build" / "train_lm_ckpt"
    reset_counts()
    res = train_lm.main(["--steps", "60", "--ckpt-dir", str(ckpt)])
    torch.cuda.synchronize()
    launches = counts()
    need(launches == launch_counts(flash=60 * 8 * 2), f"train_lm launches {launches}")
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    need(res["cfg"].name == "nemo-100m" and res["opt_step"] == 60, "train_lm: config or steps")
    need(len(losses) == 6 and all(np.isfinite(losses)), f"train_lm losses {losses}")
    need(losses[-1] < losses[0], f"train_lm: loss did not fall: {losses}")
    rec = {"arch": res["cfg"].name, "params": res["n_params"], "steps": res["steps"],
           "history": hist, "s_per_step": [h["s_per_step"] for h in hist],
           "seconds": res["seconds"], "checkpoints": res["checkpoints"],
           "launches": launches}
    print("train_lm", json.dumps(rec), flush=True)
    return rec


# -- phase 12: the dispatcher ---------------------------------------------------

# training steps: the quickstart's 2000 on H100; Het-4Mix is cut to 500 to
# keep the phase near two minutes (``dispatch_train`` prints the R² reached)
DISPATCH_CLUSTERS = {"H100": 2000, "Het-4Mix": 500}
CURVE_STEPS = 50
# card against CPU, both fp32 with TF32 off, sums in other orders: a loss
# curve 2e-3 relative a step (Adam magnifies early rounding, as in the CPU
# tests against the reference); a decoded score 1e-4 relative (expm1(5 y)
# of a normalized output within 2e-5); a descent round's scores 1e-5
# relative to the same predictor's host loop on the card
CURVE_RTOL = 2e-3
SCORE_RTOL = 1e-4
SCAN_RTOL = 1e-5


def on_cpu(params):
    return copy.deepcopy(params).to("cpu")  # Module.to moves in place


def multi_host_subsets(cl, rng, n, exclude=()):
    pool = [g for g in range(cl.n_gpus) if g not in set(exclude)]
    out = []
    while len(out) < n:
        s = sorted(rng.choice(pool, size=int(rng.integers(2, 25)), replace=False).tolist())
        if len(cl.partition_by_host(s)) > 1:
            out.append(s)
    return out


def max_rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))


def dispatch_train(name, steps):
    """The quickstart's training on the card; the first CURVE_STEPS steps'
    losses again on the CPU from the same init and batches."""
    cl = core.PAPER_CLUSTERS[name]()
    sim = core.BandwidthSimulator(cl)
    tables = core.IntraHostTables(cl, sim)
    train, test = core.make_train_test_split(sim, 250, seed=0)
    init = surr.init_hierarchical_params(torch.Generator().manual_seed(0), device="cpu")
    params, info = core.train_surrogate(cl, tables, train, core.TrainConfig(steps=steps),
                                        init_params=init)
    need(params.device.type == "cuda", "the surrogate did not train on the card")
    acc = core.evaluate_surrogate(core.SurrogatePredictor(cl, tables, params), test)
    short = core.TrainConfig(steps=CURVE_STEPS)
    _, card = core.train_surrogate(cl, tables, train, short, init_params=init)
    _, cpu = core.train_surrogate(cl, tables, train, short, init_params=init, device="cpu")
    curve_err = max_rel(card["loss_curve"], cpu["loss_curve"])
    need(curve_err <= CURVE_RTOL, f"{name}: card and CPU loss curves differ by {curve_err}")
    rec = {"cluster": name, "steps": steps, "train_s": info["train_seconds"],
           "ms_per_step": info["train_seconds"] / steps * 1e3,
           "final_loss": info["final_loss"], "r2": acc["r2"], "mape": acc["mape"],
           "curve_steps": CURVE_STEPS, "curve_max_rel_err": curve_err,
           "curve_tol": CURVE_RTOL, "param_bytes": info["param_bytes"]}
    print("dispatch_train", json.dumps(rec), flush=True)
    need(np.isfinite(info["final_loss"]) and acc["r2"] > 0.5, f"{name}: surrogate did not learn")
    return (cl, sim, tables), params, rec


def tenanted_ledger(cl):
    led = core.JobLedger(cl)
    led.admit("a", [0, 1, cl.hosts[1].gpu_ids[0]])
    led.admit("b", [cl.hosts[1].gpu_ids[1], cl.hosts[-1].gpu_ids[0]])
    led.admit("c", list(cl.hosts[2].gpu_ids[:2]) + [cl.hosts[3].gpu_ids[1]])
    return led


def timed_apply(fn, params, x, m):
    """(decoded scores, device ms of the apply under CUDA events, or None on
    the CPU)."""
    if params.device.type != "cuda":
        return surr._apply_np(fn, params, x, m), None
    xt, mt = torch.from_numpy(x).cuda(), torch.from_numpy(m).cuda()
    ms = cuda_ms(lambda: fn(params, xt, mt), iters=20)
    return fn(params, xt, mt).cpu().numpy(), ms


def score_check(stack, params):
    """4096 random multi-host subsets, card against CPU, isolated and (with
    a random context embedding, against a tenanted ledger) contended."""
    cl, _, tables = stack
    rng = np.random.default_rng(1)
    subsets = multi_host_subsets(cl, rng, 4096)
    x, m = core.features.featurize_batch(cl, tables, subsets)
    card, card_ms = timed_apply(surr._apply_hierarchical_bw, params, x, m)
    cpu, _ = timed_apply(surr._apply_hierarchical_bw, on_cpu(params), x, m)
    cparams = surr.init_contended_params(params)
    with torch.no_grad():
        cparams.ctx_embed.w.copy_(torch.randn(cparams.ctx_embed.w.shape,
                                              generator=torch.Generator().manual_seed(5)) * 0.3)
    led = tenanted_ledger(cl)
    free = multi_host_subsets(cl, rng, 4096, exclude=led.busy())
    cx, cm = core.features.featurize_contended_batch(cl, tables, [(s, led) for s in free])
    ccard, ccard_ms = timed_apply(surr._apply_contended_bw, cparams, cx, cm)
    ccpu, _ = timed_apply(surr._apply_contended_bw, on_cpu(cparams), cx, cm)
    rec = {"cluster": cl.name, "n": len(subsets), "tokens": int(x.shape[1]),
           "hierarchical_max_rel_err": max_rel(card, cpu), "hierarchical_ms": card_ms,
           "contended_max_rel_err": max_rel(ccard, ccpu), "contended_ms": ccard_ms,
           "tol": SCORE_RTOL}
    print("dispatch_scores", json.dumps(rec), flush=True)
    need(rec["hierarchical_max_rel_err"] <= SCORE_RTOL
         and rec["contended_max_rel_err"] <= SCORE_RTOL, f"{cl.name}: card scores disagree")
    return rec


def fig1_phase(stack, params):
    cl, sim, tables = stack
    pred = core.SurrogatePredictor(cl, tables, params)
    avail = list(range(0, 6)) + list(range(8, 14))
    bp = core.BandPilotDispatcher(cl, tables, pred)
    topo = core.BaselineDispatcher(cl, "topo")
    s_bp, s_topo = bp.dispatch(avail, 8), topo.dispatch(avail, 8)
    split = sorted(len(v) for v in cl.partition_by_host(s_bp).values())
    bw_bp, bw_topo = sim.true_bandwidth(s_bp), sim.true_bandwidth(s_topo)
    need(split == [4, 4], f"Fig. 1: BandPilot chose {s_bp}, not a 4+4 split")
    need(bw_bp > bw_topo, f"Fig. 1: BandPilot {bw_bp} GB/s does not beat Topo {bw_topo}")
    ds = [bp, topo, core.BaselineDispatcher(cl, "default"), core.BaselineDispatcher(cl, "random")]
    t0 = time.perf_counter()
    recs = core.evaluate_dispatchers(cl, sim, tables, ds, request_sizes=[4, 8, 12, 16, 20],
                                     n_scenarios=10, seed=1)
    gbe = {name: s["mean_gbe"] for name, s in core.summarize(recs).items()}
    rec = {"cluster": cl.name, "bandpilot": s_bp, "bandpilot_gbps": bw_bp, "topo": s_topo,
           "topo_gbps": bw_topo, "mean_gbe": gbe, "protocol_s": time.perf_counter() - t0,
           "descents": pred.n_descents, "graph_replays": pred.n_graph_replays}
    print("dispatch_fig1", json.dumps(rec), flush=True)
    need(gbe["BandPilot"] > max(gbe["Topo"], gbe["Default"], gbe["Random"]),
         "BandPilot does not lead the dispatcher comparison")
    return rec


def audit_descent(pred, res, parent, k):
    """Every round of a descent against the predictor's own host loop: the
    scores within SCAN_RTOL, the same elimination."""
    s = sorted(parent)
    worst = 0.0
    for r in range(res.n_rounds):
        live = np.nonzero(res.sels[r])[0]
        need([sorted(parent)[i] for i in live] == s, "descent audit: live slots differ")
        host = np.float32(pred.predict([s[:i] + s[i + 1:] for i in range(len(s))]))
        worst = max(worst, max_rel(res.scores[r][live], host))
        j = int(np.argmax(host))
        need(res.elims[r] == live[j], f"descent audit: round {r} eliminated another slot")
        s.pop(j)
    need(res.subset == s and len(s) == k and worst <= SCAN_RTOL,
         f"descent audit failed (worst round score error {worst})")
    return worst


def host_descent(pred, parent, k):
    """pts_search's host loop (the use_scan=False path)."""
    s = sorted(parent)
    while len(s) > k:
        j = int(np.argmax(pred.predict_children(s)))
        s = s[:j] + s[j + 1:]
    return s


def descent_phase(stack, params, reps=20):
    cl, _, tables = stack
    pred = core.SurrogatePredictor(cl, tables, params)
    warm_s = pred.warm_scan()  # 0 where a same-shaped cluster captured the buckets
    off = core.SurrogatePredictor(cl, tables, params, use_scan=False)
    cpu = core.SurrogatePredictor(cl, tables, on_cpu(params))
    parent = list(range(cl.n_gpus))
    rows = []
    for k in (4, 8, 16):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        wall, dev = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            res = pred.eliminate_to(parent, k)
            ev1.record()
            wall.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            dev.append(ev0.elapsed_time(ev1))
        worst = audit_descent(pred, res, parent, k)
        need(host_descent(off, parent, k) == res.subset, "descent: use_scan=False chose otherwise")
        need(cpu.eliminate_to(parent, k).subset == res.subset, "descent: the CPU chose otherwise")
        rows.append({"k": k, "rounds": res.n_rounds, "ms_median": float(np.median(wall)),
                     "events_ms_median": float(np.median(dev)), "ms_first": wall[0],
                     "audit_worst_rel_err": worst, "subset": res.subset})
    need(pred.n_graph_replays == pred.n_descents, "a descent on the card was not a graph replay")
    rec = {"cluster": cl.name, "warm_scan_s": warm_s, "graphs": surr.scan_graphs(),
           "descents": pred.n_descents, "graph_replays": pred.n_graph_replays, "parent": 32,
           "per_k": rows}
    print("dispatch_descent", json.dumps(rec), flush=True)
    return rec


def trace_run(stack, params, trace, cparams=None):
    """One AdmissionScheduler replay (fifo): the dispatch log, wall seconds,
    the predictor chain's stats and the base predictor's descent counts."""
    cl, sim, tables = stack
    pred = core.SurrogatePredictor(cl, tables, params)
    kw = {}
    if cparams is not None:
        kw = {"contention_mode": "learned",
              "contended_predictor": core.ContendedSurrogatePredictor(cl, tables, cparams)}
    disp = core.BandPilotDispatcher(cl, tables, pred, **kw)
    log = []
    orig = disp.dispatch

    def logged(avail, k, rng=None):
        s = orig(avail, k, rng=rng)
        log.append((list(s), disp.last_result.predicted_bw))
        return s

    disp.dispatch = logged
    t0 = time.perf_counter()
    recs = core.AdmissionScheduler(cl, sim, tables, disp).run(trace)
    return log, recs, time.perf_counter() - t0, disp.predictor_stats(), pred


def first_divergence(log, cpu_log):
    """The index of the first dispatch whose subset differs between the card
    and the CPU, or None. Where one differs, the two choices' predicted
    bandwidths must be a near-tie (within SCORE_RTOL): the card's float32
    sums and the CPU's ordered two equally good candidates differently, and
    from there on the two ledgers, and so the runs, part ways."""
    for i, ((s, bw), (cs, cbw)) in enumerate(zip(log, cpu_log)):
        if s != cs:
            need(abs(bw - cbw) <= SCORE_RTOL * abs(cbw),
                 f"dispatch {i}: card {s} ({bw} GB/s) against CPU {cs} ({cbw} GB/s)")
            return i
    need(len(log) == len(cpu_log), "the card and the CPU dispatched different counts")
    return None


def trace_phase(stack, params, name, trace, cparams=None):
    log, recs, secs, stats, pred = trace_run(stack, params, trace, cparams)
    cpu_log, cpu_recs, cpu_secs, _, _ = trace_run(
        stack, on_cpu(params), trace, None if cparams is None else on_cpu(cparams))
    split = first_divergence(log, cpu_log)
    same = len(log) if split is None else split
    need([(r.job_id, r.t_admit, r.bw) for r in recs[:same]]
         == [(r.job_id, r.t_admit, r.bw) for r in cpu_recs[:same]],
         f"{name}: the card's admissions differ from the CPU's")
    n = len(log)
    us = lambda s: s / max(n, 1) * 1e6  # noqa: E731
    other = secs - stats.featurize_seconds - stats.infer_seconds - stats.scan_seconds
    rec = {"trace": name, "cluster": stack[0].name, "jobs": len(trace), "admissions": n,
           "mode": "analytic" if cparams is None else "learned",
           "identical_dispatches": same,
           "near_tie": None if split is None else {
               "dispatch": split, "card": log[split], "cpu": cpu_log[split]},
           "us_per_admission": us(secs), "cpu_us_per_admission": us(cpu_secs),
           "featurize_us": us(stats.featurize_seconds), "infer_us": us(stats.infer_seconds),
           "scan_us": us(stats.scan_seconds), "other_us": us(other),
           "model_calls": stats.n_model_calls, "descents": pred.n_descents,
           "graph_replays": pred.n_graph_replays, "scan_rounds": stats.n_scan_steps,
           "mean_gbe": float(np.mean([r.gbe for r in recs]))}
    print("dispatch_trace", json.dumps(rec), flush=True)
    need(pred.n_graph_replays == pred.n_descents, f"{name}: a descent was not a graph replay")
    need(cparams is not None or pred.n_descents > 0, f"{name}: no descent ran")
    return rec


def dispatch_phase():
    reset_counts()
    t0 = time.perf_counter()
    trained = {name: dispatch_train(name, steps) for name, steps in DISPATCH_CLUSTERS.items()}
    rec = {"train": [t[2] for t in trained.values()]}
    rec["scores"] = [score_check(stack, params) for stack, params, _ in trained.values()]
    rec["descent"] = [descent_phase(stack, params) for stack, params, _ in trained.values()]
    rec["fig1"] = fig1_phase(*trained["H100"][:2])
    rec["traces"] = []
    for name, (stack, params, _) in trained.items():
        cl = stack[0]
        k_choices = range(4, cl.n_gpus // 2 + 1)
        golden = core.poisson_trace(cl, 14, np.random.default_rng(7), mean_interarrival=1.0,
                                    mean_duration=6.0, k_choices=k_choices)
        poisson = core.poisson_trace(cl, 200, np.random.default_rng(11), mean_interarrival=1.0,
                                     mean_duration=8.0, k_choices=k_choices)
        rec["traces"].append(trace_phase(stack, params, "golden-14-fifo", golden))
        rec["traces"].append(trace_phase(stack, params, "poisson-200", poisson))
        if name == "H100":
            samples = core.build_contended_dataset(stack[1], 256, np.random.default_rng(2))
            cparams, cinfo = core.train_contended_surrogate(
                cl, stack[2], core.to_triples(cl, samples), core.TrainConfig(steps=300),
                base_params=params)
            rec["contended_train_s"] = cinfo["train_seconds"]
            rec["traces"].append(trace_phase(stack, params, "golden-14-fifo", golden, cparams))
            rec["traces"].append(trace_phase(stack, params, "poisson-200", poisson, cparams))
    rec["launches"] = counts()
    need(all(v == 0 for v in rec["launches"].values()), "a port kernel ran on the dispatch path")
    rec["seconds"] = time.perf_counter() - t0
    print(f"dispatch: {rec['seconds']:.1f} s", flush=True)
    return rec


# -- phase 13: BandPilot-placed training, a failure and the recovery -------------

# (b) against (a): the same fp32 masters, bf16 compute and batches, the step
# on a 1-rank mesh gathers and reduces nothing; restored state is exact
ELASTIC_RTOL = 1e-5


def coordinator_log(flow):
    """(c): ``run_elastic_training``'s events with no training, on the CPU."""
    cl = core.h100_cluster()
    sim = core.BandwidthSimulator(cl)
    disp = core.BandPilotDispatcher(cl, core.IntraHostTables(cl, sim),
                                    core.GroundTruthPredictor(sim))
    failures = [FailureEvent(step=flow.fail_at, failed_gpus=list(flow.failed_gpus))]

    def no_training(alloc, start):
        return min((f.step for f in failures if f.step > start), default=flow.steps), 0.0

    log = run_elastic_training(ElasticCoordinator(cl, disp, request_size=flow.request),
                               no_training, failures, flow.steps)
    return [e for e in log if e["event"] != "train"]


def elastic_phase():
    flow = launch_elastic.card_flow()
    cfg = flow.cfg
    need(cfg.n_groups_and_tail() == (1, 0) and cfg.d_model == 4096, "elastic: config")
    per_step = launch_counts(flash_wgmma=2, rglru=6)
    scaled = lambda n: {k: v * n for k, v in per_step.items()}  # noqa: E731

    # (a) uninterrupted
    model = build_model(cfg)
    lm = model.init(SEED, torch.float32)
    n_params = sum(p.numel() for p in lm.parameters())
    data = flow.data()
    batches = [data.batch(i) for i in range(flow.steps)]
    events = []
    reset_counts()
    lm, state, hist = train_loop(model, lm, timed_batches(batches, events), flow.run_config(),
                                 log_every=1)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    events.append(end)
    launches_a = counts()
    need(launches_a == scaled(flow.steps), f"elastic (a) launches {launches_a}")
    losses_a = [h["loss"] for h in hist]
    step_ms_a = [x.elapsed_time(y) for x, y in zip(events, events[1:])]
    del lm, state
    torch.cuda.empty_cache()

    # (b) through a failure; the checkpoint goes under the temporary directory
    ckpt_dir = tempfile.mkdtemp(prefix="elastic_", dir=tempfile.gettempdir())
    need_bytes = (flow.keep + 1) * launch_elastic.checkpoint_bytes(cfg)
    free = shutil.disk_usage(ckpt_dir).free
    print(f"elastic: {free} bytes free under {tempfile.gettempdir()}, "
          f"{need_bytes} needed", flush=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        with process_group("cuda"):
            out = launch_elastic.run(flow, torch.device("cuda"), ckpt_dir, seed=SEED)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches_b = counts()
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    need(launches_b == scaled(flow.steps), f"elastic (b) launches {launches_b}")
    losses_b = [h["loss"] for h in out["history"]]
    need([h["step"] for h in out["history"]] == list(range(1, flow.steps + 1)),
         "elastic (b): a step was not logged")
    rel = [abs(x - y) / abs(y) for x, y in zip(losses_b, losses_a)]
    need(all(np.isfinite(losses_b)) and max(rel) <= ELASTIC_RTOL,
         f"elastic: resumed losses {losses_b} against {losses_a}")
    redispatch = out["log"][2]
    need(not set(redispatch["alloc"]) & set(flow.failed_gpus),
         f"elastic: {redispatch['alloc']} re-uses a GPU of the dead host")

    # (c) the coordinator on the CPU
    log_b = [e for e in out["log"] if e["event"] != "train"]
    log_c = coordinator_log(flow)
    need(json.dumps(log_b, default=float) == json.dumps(log_c, default=float),
         f"elastic: event log {log_b} on the card, {log_c} on the CPU")

    # the launcher: 2 steps of the sharded step on a 1-rank mesh
    reset_counts()
    res = launch_train.main(["--arch", "recurrentgemma-9b", "--steps", "2",
                             "--global-batch", "1", "--seq-len", "2048", "--log-every", "1",
                             "--seed", str(SEED)], cfg=cfg)
    launches_train = counts()
    need(res["opt_step"] == 2 and all(np.isfinite([h["loss"] for h in res["history"]])),
         f"launch.train: {res['history']}")
    need(launches_train == scaled(2), f"launch.train launches {launches_train}")

    saves = {s["step"]: s for s in out["saves"]}
    warm = [2, 5]  # (b)'s steps with no save in them, not the first after a (re)start
    step_ms_b = [out["step_ms"][i] for i in range(1, flow.steps + 1)]
    warm_a = float(np.median(step_ms_a[1:]))  # (a) saves nothing; its first step is cold
    warm_b = float(np.median([step_ms_b[i - 1] for i in warm]))
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "compute_dtype": "bfloat16", "master_dtype": "float32",
           "batch": flow.batch, "seq": flow.seq, "steps": flow.steps,
           "fail_at": flow.fail_at, "failed_gpus": list(flow.failed_gpus),
           "losses_a": losses_a, "losses_b": losses_b, "max_rel_err": max(rel),
           "tol": ELASTIC_RTOL, "bit_equal": losses_a == losses_b,
           "step_ms_a": step_ms_a, "step_ms_b": step_ms_b,
           "step_ms_b_includes_save": sorted(saves),
           "warm_steps_b": warm, "step_ms_a_median_warm": warm_a,
           "step_ms_b_median_warm": warm_b, "sharded_overhead_ms": warm_b - warm_a,
           "log": out["log"], "log_cpu": log_c, "allocations": out["allocations"],
           "checkpoint_bytes": out["checkpoint_bytes"], "free_bytes": free,
           "needed_bytes": need_bytes, "saves": out["saves"],
           "recover": out["recover"], "peak_mem_gib_b": peak_b,
           "launches_a": launches_a, "launches_b": launches_b,
           "launch_train": {"history": res["history"], "launches": launches_train,
                            "mesh": res["mesh"], "chosen": res["chosen"]}}
    rec = json.loads(json.dumps(rec, default=float))  # numpy scalars of the dispatcher
    print("elastic", json.dumps(rec), flush=True)
    return rec


# -- phase 14: the dry run against the card ------------------------------------

DRYRUN_MEM_RTOL = 0.15
DRYRUN_CELLS = [("internvl2-76b", "train_4k"), ("internvl2-76b", "prefill_32k"),
                ("internvl2-76b", "decode_32k"), ("recurrentgemma-9b", "long_500k")]


def measure_step(step):
    """One call of ``step`` under ``FlopCounterMode`` (cold, counted), then one
    under CUDA events with the peak memory reset just before: (FLOPs, ms,
    peak bytes, the first call's launches, a train step's two losses)."""
    reset_counts()
    with FlopCounterMode(display=False) as fc:
        first = step()
    torch.cuda.synchronize()
    launches = counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.reset_peak_memory_stats()
    start.record()
    second = step()
    end.record()
    torch.cuda.synchronize()
    losses = ([float(out[2]["loss"]) for out in (first, second)] if step.kind == "train"
              else None)
    return fc.get_total_flops(), start.elapsed_time(end), torch.cuda.max_memory_allocated(), \
        launches, losses


def dryrun_check_case(cfg, cell, mesh, build, line="dryrun_check", **kw):
    """The step traced on meta by the dry run (predicted) and run on the card
    (measured), on a 1-rank mesh."""
    step = build(cfg, cell, mesh, device="meta", **kw)
    predicted = dryrun.trace(step)
    rep = roofline.analyze_from_costs(cfg.name, cfg, cell.name, cell.kind, "1x1", 1, predicted,
                                      predicted["peak_bytes"], cell.global_batch, cell.seq_len)
    del step
    step = build(cfg, cell, mesh, device="cuda", seed=SEED, **kw)
    flops, ms, peak, launches, losses = measure_step(step)
    del step
    torch.cuda.empty_cache()
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "kind": cell.kind,
           "batch": cell.global_batch, "prefix_rows": cfg.frontend_seq_len, "seq": cell.seq_len,
           "flops_predicted": predicted["flops"], "flops_measured": flops,
           "peak_gib_predicted": predicted["peak_bytes"] / 2**30,
           "peak_gib_measured": peak / 2**30,
           "peak_rel_err": abs(predicted["peak_bytes"] - peak) / peak,
           "peak_by_category_gib": {k: v / 2**30
                                    for k, v in predicted["peak_by_category"].items()},
           "bytes_predicted": predicted["bytes"], "collectives": predicted["by_kind"],
           "roofline_ms": {"compute": rep.compute_s * 1e3, "memory": rep.memory_s * 1e3,
                           "collective": rep.collective_s * 1e3},
           "bottleneck": rep.bottleneck, "measured_ms": ms,
           "measured_over_roofline": ms / (rep.step_time_s * 1e3), "launches": launches,
           "n_ops": predicted["n_ops"], "losses": losses}
    print(line, json.dumps(rec), flush=True)
    need(flops == predicted["flops"], f"dryrun {cell.kind}: FLOPs {predicted['flops']} "
                                      f"predicted, {flops} counted on the card")
    need(rec["peak_rel_err"] <= DRYRUN_MEM_RTOL,
         f"dryrun {cell.kind}: peak {rec['peak_gib_predicted']} GiB predicted, "
         f"{rec['peak_gib_measured']} measured")
    return rec


def dryrun_cli(out_dir):
    """``python -m repro_torch.launch.dryrun`` for each of DRYRUN_CELLS, all at
    once (no card: the trace is on meta tensors in a fake 256-rank world)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    try:
        for arch, shape in DRYRUN_CELLS:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--out", str(out_dir / f"dryrun_{arch}_{shape}")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    records = []
    for (arch, shape), p, out in zip(DRYRUN_CELLS, procs, outs):
        need(p.returncode == 0, f"dryrun {arch} x {shape} exited {p.returncode}:\n{out[-3000:]}")
        lines = (out_dir / f"dryrun_{arch}_{shape}.jsonl").read_text().splitlines()
        records.extend(json.loads(line) for line in lines)
        print(out[out.index("arch   "):].split("\nwrote")[0].strip(), flush=True)
    need(all(r["status"] == "ok" for r in records), "dryrun: a cell did not run")
    return records


def dryrun_check_phase():
    """The dry run held against the card on a 1-rank NCCL mesh: internvl2-76b
    train at full width cut to 1 layer, B 1 x (256 + 2048), and vlm_serve's
    prefill (24 layers, B 4 x (256 + 2304), a 4096-slot cache), each traced
    and run; then the CLI on four cells of the 16 x 16 mesh."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with process_group("cuda"):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
        train = dryrun_check_case(vlm_cfg(1), shapes.ShapeCell("vlm_train_check", 2048, 1,
                                                               "train"),
                                  mesh, steps.build_train_step)
        prefill = dryrun_check_case(vlm_cfg(VLM_LAYERS),
                                    shapes.ShapeCell("vlm_serve_prefill", VLM_S, VLM_B,
                                                     "prefill"),
                                    mesh, steps.build_prefill_step, cache_len=VLM_MAX_LEN)
    need(train["launches"] == launch_counts(flash_wgmma=2)
         and prefill["launches"] == launch_counts(flash_wgmma=VLM_LAYERS),
         f"dryrun check launches {train['launches']}, {prefill['launches']}")
    return {"train": train, "prefill": prefill, "cli": dryrun_cli(out_dir)}


# -- phase 15: the perf experiments ---------------------------------------------

PERF_CELL = "internvl2-76b:train_4k"
PERF_EXPS = ("baseline", "cast_barrier", "rs_grads", "chunked_attn", "bf16_wire", "grad_bf16",
             "no_seq_shard")
PERF_REFUSED = "moe_ep2d"
PERF_SAME_AS_BASELINE = ("rs_grads", "chunked_attn")


def perf_check_phase():
    """(b)'s CLI subprocesses start first and run on the host's cores while
    (a) runs on the card (the module docstring)."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    try:
        for exp in PERF_EXPS + (PERF_REFUSED,):
            out = out_dir / f"perf_{exp}"
            Path(f"{out}.jsonl").unlink(missing_ok=True)
            procs[exp] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.perf", "--cell", PERF_CELL, "--exp",
                 exp, "--out", str(out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        cell = shapes.ShapeCell("vlm_train_check", 2048, 1, "train")
        runs = {}
        with process_group("cuda"):
            mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"), "cuda")
            for exp in ("baseline", "cast_barrier"):
                with perf.environment(perf.EXPERIMENTS[exp].get("env", {})):
                    runs[exp] = dryrun_check_case(vlm_cfg(1), cell, mesh,
                                                  steps.build_train_step,
                                                  line=f"perf_check_train {exp}")
        outs = {exp: p.communicate(timeout=600)[0] for exp, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    base, cast = runs["baseline"], runs["cast_barrier"]
    need(cast["losses"] == base["losses"],
         f"perf_check: losses {cast['losses']} under cast_barrier, {base['losses']} without")
    need(all(r["launches"] == launch_counts(flash_wgmma=2) for r in runs.values()),
         f"perf_check launches {[r['launches'] for r in runs.values()]}")
    records = {}
    for exp in PERF_EXPS:
        p, out = procs[exp], outs[exp]
        need(p.returncode == 0, f"perf {exp} exited {p.returncode}:\n{out[-3000:]}")
        need(f"[{exp:<28}] compute=" in out, f"perf {exp}: no row in\n{out[-3000:]}")
        print(next(row for row in out.splitlines() if row.startswith(f"[{exp:<28}]")),
              flush=True)
        records[exp] = json.loads((out_dir / f"perf_{exp}.jsonl").read_text())
    gathers = {exp: records[exp]["by_axis"]["all-gather"]["data"]
               for exp in ("baseline", "cast_barrier")}
    need(2 * gathers["cast_barrier"] == gathers["baseline"],
         f"perf: weight gathers over data {gathers}")
    for exp in PERF_SAME_AS_BASELINE:
        need({k: v for k, v in records[exp].items() if k not in ("experiment", "wall_s")}
             == {k: v for k, v in records["baseline"].items()
                 if k not in ("experiment", "wall_s")}, f"perf: {exp} is not baseline")
    refused = outs[PERF_REFUSED]
    need(procs[PERF_REFUSED].returncode == 1 and perf.EXPERT_FF_ON_DATA in refused,
         f"perf {PERF_REFUSED} exited {procs[PERF_REFUSED].returncode}:\n{refused[-3000:]}")
    rec = {"cell": PERF_CELL, "train_1_rank": runs, "cli": records,
           "weight_gathers_over_data_gib": {k: v / 2**30 for k, v in gathers.items()},
           "refused": {PERF_REFUSED: procs[PERF_REFUSED].returncode}}
    print("perf_check", json.dumps({k: rec[k] for k in ("cell", "weight_gathers_over_data_gib",
                                                        "refused")}
                                   | {"losses": base["losses"],
                                      "ms": {k: r["measured_ms"] for k, r in runs.items()},
                                      "wall_s": {k: r["wall_s"] for k, r in records.items()}}),
          flush=True)
    return rec


WHISPER_FLASH_KEYS = ("case", "ms", "graph_ms", "bound_ms", "bound_by", "share_of_bound",
                      "previous_ms", "library_ms", "library_graph_ms", "library_call", "plain_ms",
                      "max_abs_err")


def kernel_record(name, route, source, replaces, launches, main, checks, **extra):
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"], **extra,
            "checks": [main] + checks}


def function_name(mangled):
    """The function's own name in a mangled _ZN<len><namespace><len><name>..."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return ""
    rest = mangled[m.end() + int(m.group(1)):]
    n = re.match(r"(\d+)", rest)
    return rest[n.end():n.end() + int(n.group(1))] if n else ""


def print_ptxas(kern):
    """Registers, spills and ptxas warnings of each entry function built."""
    entry = ""
    for line in kern.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:  # the function's name and template arguments: type, head_dim
            name = m.group(1)
            fn = function_name(name)
            d = re.search(r"Li(\d+)E", name)
            dtype = "bf16" if "bfloat16" in name else "fp32" if re.search(r"If(Li|E)", name) else ""
            entry = " ".join(filter(None, [fn, dtype, d and f"head_dim {d.group(1)}"]))
        elif "registers" in line or "spill" in line or "C75" in line:
            print(f"ptxas {kern.name} [{entry}]: {line.strip()}", flush=True)


def print_rings():
    """The ring depth and shared memory per block of the WKV6 kernel and of
    the RG-LRU scan's ring path, from their libraries."""
    lib = ctypes.CDLL(str(wkv_ops.KERNEL.library))
    d = (ctypes.c_int * 6)()
    lib.wkv6_design(d)
    print(f"wkv6: {d[4]} chunks of {d[3]} steps in the ring; {d[0]} columns a block, "
          f"{d[1]} threads sharing each group of {d[2]} columns, {d[5]} threads a block; "
          f"dynamic shared memory per block "
          f"bf16 {lib.wkv6_smem_bytes(1)} bytes, fp32 {lib.wkv6_smem_bytes(0)} bytes",
          flush=True)
    lib = ctypes.CDLL(str(lru_ops.KERNEL.library))
    d = (ctypes.c_int * 3)()
    lib.rglru_scan_design(d)
    print(f"rglru_scan ring path: {d[2]} stages of {d[1]} steps x {d[0]} channels; "
          f"dynamic shared memory per block bf16 {lib.rglru_scan_smem_bytes(1, 1)} bytes, "
          f"fp32 {lib.rglru_scan_smem_bytes(0, 0)} bytes, "
          f"bf16 a with fp32 b {lib.rglru_scan_smem_bytes(1, 0)} bytes", flush=True)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    need(not perf.stray_knobs(), f"set outside perf.environment: {perf.stray_knobs()} "
         "(they change the plain reference every kernel is held against)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    secs = cuda_build.build(KERNELS)
    print(f"build: {secs:.1f} s for {len(KERNELS)} kernels", flush=True)
    for kern in KERNELS:
        print_ptxas(kern)
    smem = ctypes.CDLL(str(fa_ops.WGMMA_KERNEL.library)).flash_attention_sm90_smem_bytes
    print("flash_attention_wgmma dynamic shared memory per block: " + ", ".join(
        f"head_dim {d} {smem(d)} bytes" for d in fa_ops.WGMMA_HEAD_DIMS), flush=True)
    print_rings()

    phase_s = {}

    def phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        return out

    (flash, flash_checks, simt_checks, whisper_flash), (lru, lru_checks), (wkv, wkv_checks) = \
        phase("kernels", kernel_phase)
    lru_mixed = next(c for c in lru_checks if c["dtype_b"] != c["dtype"] and "ms" in c)
    serve = phase("serve", recurrentgemma_serve_phase)
    # fp32 over the cut depth and a 256000-way head (rwkv6: 65536); logits O(1)
    check = phase("check", model_check_phase, "recurrentgemma-9b", 3,
                  launch_counts(flash=1, rglru=2), 2e-3)
    gemma2 = phase("gemma2", gemma2_phase)
    rwkv6 = phase("rwkv6", rwkv6_serve_phase)
    rwkv6_check = phase("rwkv6_check", model_check_phase, "rwkv6-7b", 2,
                        launch_counts(wkv=8), 2e-3)
    moe_cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=8)
    need((moe_cfg.d_model, moe_cfg.n_heads, moe_cfg.n_kv_heads, moe_cfg.head_dim,
          moe_cfg.n_experts, moe_cfg.experts_per_token, moe_cfg.qk_norm)
         == (4096, 64, 4, 128, 128, 8, True), "qwen3-moe width")
    moe_serve, moe_state = phase("moe_serve", moe_serve_phase, moe_cfg)
    ep = phase("ep", ep_phase, moe_serve, moe_state)
    del moe_state
    torch.cuda.empty_cache()
    # fp32 over one full-width layer (128 experts) and a 151936-way head
    moe_check = phase("moe_check", model_check_phase, "qwen3-moe-235b-a22b", 1,
                      launch_counts(flash=1), 2e-3)
    whisper_serve = phase("whisper_serve", whisper_serve_phase, whisper_flash[0])
    torch.cuda.empty_cache()
    # fp32 over 2 + 2 full-width layers and a 51865-way head, as the other checks
    whisper_check = phase("whisper_check", whisper_check_phase, 2e-3)
    vlm_flash = next(c for c in flash_checks if c["case"] == "internvl2-76b prefill")
    vlm_serve, vlm_state = phase("vlm_serve", vlm_serve_phase, vlm_flash)
    tp_serve = phase("tp_serve", tp_serve_phase, vlm_serve, vlm_state)
    del vlm_state
    torch.cuda.empty_cache()
    # fp32 over 2 full-width layers and a 128256-way head; the loss and
    # gradients with train_check's tolerances
    vlm_check = phase("vlm_check", vlm_check_phase, 2e-3, 1e-4, 2e-3)
    tp_train = phase("tp_train", tp_train_phase)
    sp_train = phase("sp_train", sp_train_phase, tp_train)
    rnn_split = phase("rnn_split", rnn_split_phase)
    rwkv_split = phase("rwkv_split", rwkv_split_phase)
    train = phase("train", train_phase)
    # fp32 over a 256000-way (rwkv6: 65536) softmax and 2176 (256) positions;
    # the loss is near ln(V), the tolerance 1e-4 absolute; each gradient within
    # 2e-3 of its leaf's largest, the summation orders of card and CPU apart
    train_check = phase("train_check", train_check_phase, "recurrentgemma-9b", 3, 1, 2176,
                        launch_counts(flash=1, rglru=2 * 2), 1e-4, 2e-3)
    rwkv6_train_check = phase("rwkv6_train_check", train_check_phase, "rwkv6-7b", 2, 1, 256,
                              launch_counts(), 1e-4, 2e-3)
    # the one layer is a remat group: flash in the forward and the recompute
    moe_train_check = phase("moe_train_check", train_check_phase, "phi3.5-moe-42b-a6.6b",
                            1, 1, 1024, launch_counts(flash=2), 1e-4, 2e-3,
                            remat_policy="nothing")
    # the tolerances of train_check: 1500 frames and 448 tokens, a 51865-way softmax
    whisper_train_check = phase("whisper_train_check", whisper_train_check_phase, 1e-4, 2e-3)
    whisper_train = phase("whisper_train", whisper_train_phase)
    torch.cuda.empty_cache()
    whisper_tp_train = phase("whisper_tp_train", whisper_tp_train_phase)
    whisper_tp_serve = phase("whisper_tp_serve", whisper_tp_serve_phase)
    train_lm_rec = phase("train_lm", train_lm_phase)
    dispatch = phase("dispatch", dispatch_phase)
    elastic = phase("elastic", elastic_phase)
    torch.cuda.empty_cache()
    dryrun_rec = phase("dryrun_check", dryrun_check_phase)
    perf_rec = phase("perf_check", perf_check_phase)
    print("phase_seconds", json.dumps(phase_s), flush=True)
    print(f"total_seconds {time.perf_counter() - t_start:.1f}", flush=True)
    elastic_launches = lambda name: {  # noqa: E731
        run: elastic[key][name] for run, key in (("a", "launches_a"), ("b", "launches_b"))}

    # the CUDA-core kernel serves fp32 (and head_dim 16 and 32); its record
    # holds its bf16 time at the serving shape and at whisper-medium's
    # encoder shape, each measured beside the tensor-core kernel
    simt_main = {"case": flash["case"] + " (bf16, CUDA-core kernel)",
                 "max_abs_err": flash["previous_max_abs_err"], "ms": flash["previous_ms"],
                 "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
                 "bound_by": flash["bound_by"], "library_ms": flash["library_ms"]}
    kernels = [
        kernel_record("flash_attention_wgmma", "cuda",
                      "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
                      "src/repro/kernels/flash_attention/flash_attention.py:103",
                      serve["launches"]["flash_attention_wgmma"], flash,
                      flash_checks + whisper_flash, previous_ms=flash["previous_ms"],
                      whisper_head_dim_64=[{key: c[key] for key in WHISPER_FLASH_KEYS}
                                           for c in whisper_flash
                                           if c["case"] not in WHISPER_TP_FLASH_CASES],
                      launches_whisper_encode=whisper_serve["launches_per_encode"][
                          "flash_attention_wgmma"],
                      launches_whisper_decode_64_steps=whisper_serve["launches_decode"][
                          "flash_attention_wgmma"],
                      launches_whisper_train_step=whisper_train["launches_per_step"][
                          "flash_attention_wgmma"],
                      launches_train_4_steps=train["launches_per_4_steps"][
                          "flash_attention_wgmma"],
                      launches_moe_serve=moe_serve["launches"]["flash_attention_wgmma"],
                      launches_elastic=elastic_launches("flash_attention_wgmma"),
                      internvl2_prefill={key: vlm_flash[key] for key in WHISPER_FLASH_KEYS
                                         if key in vlm_flash},
                      launches_vlm_prefill=vlm_serve["launches_per_prefill"][
                          "flash_attention_wgmma"],
                      launches_vlm_decode_16_steps=vlm_serve["launches_decode"][
                          "flash_attention_wgmma"],
                      tp_per_rank=[{key: c[key] for key in WHISPER_FLASH_KEYS if key in c}
                                   for c in flash_checks if c["case"] in TP_FLASH_CASES],
                      launches_tp_prefill_1_rank=tp_serve["path"]["launches_per_prefill"][
                          "flash_attention_wgmma"],
                      launches_tp_decode_16_steps=tp_serve["path"]["launches_decode"][
                          "flash_attention_wgmma"],
                      launches_tp_shares_bf16=[r["launches_shares"]["flash_attention_wgmma"]
                                               for r in tp_serve["shares"]
                                               if r["dtype"] == "bfloat16"],
                      launches_tp_serve_2d_prefill_1_rank=tp_serve["path_serve_2d"][
                          "launches_per_prefill"]["flash_attention_wgmma"],
                      launches_tp_serve_2d_decode_16_steps=tp_serve["path_serve_2d"][
                          "launches_decode"]["flash_attention_wgmma"],
                      launches_tp_grid_bf16=[
                          [r["grid"], r["launches"]["prefill"]["flash_attention_wgmma"],
                           r["launches"]["decode"]["flash_attention_wgmma"]]
                          for r in tp_serve["grid_shares"] if r["dtype"] == "bfloat16"],
                      tp_train_per_rank=[{key: c[key] for key in TP_TRAIN_FLASH_KEYS}
                                         for c in flash_checks
                                         if c["case"] in TP_TRAIN_FLASH_CASES],
                      launches_tp_train_3_steps=tp_train["path"]["sharded"]["launches"][
                          "flash_attention_wgmma"],
                      launches_tp_train_shares_bf16=[
                          r["launches_shares"]["flash_attention_wgmma"]
                          for r in tp_train["shares"] if r["terms_added_in"] == "bfloat16"],
                      launches_sp_train_shares_bf16=[
                          r["launches_shares"]["flash_attention_wgmma"]
                          for r in sp_train["shares"] if r["dtype"] == "bfloat16"],
                      launches_ep_prefill_1_rank=ep["path"]["launches_per_prefill"][
                          "flash_attention_wgmma"],
                      launches_ep_decode_16_steps=ep["path"]["launches_decode"][
                          "flash_attention_wgmma"],
                      launches_ep_serve_2d_prefill_1_rank=ep["path_serve_2d"][
                          "launches_per_prefill"]["flash_attention_wgmma"],
                      launches_ep_serve_2d_decode_16_steps=ep["path_serve_2d"][
                          "launches_decode"]["flash_attention_wgmma"],
                      launches_ep_train_3_steps=ep["train"]["sharded"]["launches"][
                          "flash_attention_wgmma"],
                      launches_whisper_tp_train_step_1_rank=whisper_tp_train["path"][
                          "sharded"]["launches"]["flash_attention_wgmma"],
                      launches_whisper_tp_shares_bf16=[
                          [r["case"], r["model_ranks"],
                           r["launches_shares"]["flash_attention_wgmma"]]
                          for r in whisper_tp_train["shares"] if r["dtype"] == "bfloat16"],
                      launches_whisper_tp_seq_shares_bf16=[
                          [r["case"], r["model_ranks"], r["memory_frames"] or r["rows"][1],
                           r["launches_shares"]["flash_attention_wgmma"]]
                          for r in whisper_tp_train["seq_shares"] if r["dtype"] == "bfloat16"],
                      whisper_tp_encode_per_rank=[
                          {key: c[key] for key in WHISPER_FLASH_KEYS if key in c}
                          for c in whisper_flash if c["case"] in WHISPER_TP_FLASH_CASES],
                      launches_whisper_tp_encode_1_rank=whisper_tp_serve["path"][
                          "launches_per_encode"]["sharded"]["flash_attention_wgmma"],
                      launches_whisper_tp_decode_65_calls_1_rank=whisper_tp_serve["path"][
                          "launches_decode"]["sharded"]["flash_attention_wgmma"],
                      launches_whisper_serve_2d_encode_1_rank=whisper_tp_serve["path"][
                          "serve_2d"]["launches_per_encode"]["flash_attention_wgmma"],
                      launches_whisper_grid_bf16=[
                          [r["grid"], r["launches"]["encode"]["flash_attention_wgmma"],
                           r["launches"]["decode"]["flash_attention_wgmma"]]
                          for r in whisper_tp_serve["grid_shares"] if r["dtype"] == "bfloat16"],
                      launches_perf_check_baseline=perf_rec["train_1_rank"]["baseline"][
                          "launches"]["flash_attention_wgmma"],
                      launches_perf_check_cast_barrier=perf_rec["train_1_rank"][
                          "cast_barrier"]["launches"]["flash_attention_wgmma"]),
        kernel_record("flash_attention", "cuda",
                      "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention/flash_attention.py:103",
                      check["launches"]["flash_attention"], simt_main, simt_checks,
                      launches_in="check: recurrentgemma-9b fp32, 3 layers",
                      launches_train_check=train_check["launches"]["flash_attention"],
                      launches_moe_check=moe_check["launches"]["flash_attention"],
                      launches_moe_train_check=moe_train_check["launches"]["flash_attention"],
                      whisper_encoder_bf16_ms=whisper_flash[0]["previous_ms"],
                      launches_whisper_check=sum(
                          n["flash_attention"] for n in whisper_check["launches"].values()),
                      launches_whisper_train_check=whisper_train_check["launches"][
                          "flash_attention"],
                      launches_train_lm_60_steps=train_lm_rec["launches"]["flash_attention"],
                      launches_vlm_check=vlm_check["launches"]["prefill"]["flash_attention"],
                      launches_tp_shares_fp32=[r["launches_shares"]["flash_attention"]
                                               for r in tp_serve["shares"]
                                               if r["dtype"] == "float32"],
                      launches_tp_grid_fp32=[
                          [r["grid"], r["launches"]["prefill"]["flash_attention"],
                           r["launches"]["decode"]["flash_attention"]]
                          for r in tp_serve["grid_shares"] if r["dtype"] == "float32"],
                      launches_tp_train_shares_fp32=[r["launches_shares"]["flash_attention"]
                                                     for r in tp_train["shares"]
                                                     if r["dtype"] == "float32"],
                      launches_sp_train_shares_fp32=[r["launches_shares"]["flash_attention"]
                                                     for r in sp_train["shares"]
                                                     if r["dtype"] == "float32"],
                      launches_whisper_tp_shares_fp32=[
                          [r["case"], r["model_ranks"], r["launches_shares"]["flash_attention"]]
                          for r in whisper_tp_train["shares"] if r["dtype"] == "float32"],
                      launches_whisper_tp_seq_shares_fp32=[
                          [r["case"], r["model_ranks"], r["memory_frames"] or r["rows"][1],
                           r["launches_shares"]["flash_attention"]]
                          for r in whisper_tp_train["seq_shares"] if r["dtype"] == "float32"],
                      launches_whisper_grid_fp32=[
                          [r["grid"], r["launches"]["encode"]["flash_attention"],
                           r["launches"]["decode"]["flash_attention"]]
                          for r in whisper_tp_serve["grid_shares"] if r["dtype"] == "float32"]),
        kernel_record("rglru_scan", "cuda",
                      "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
                      "src/repro/kernels/rglru/rglru.py:69",
                      serve["launches"]["rglru_scan"], lru, lru_checks, path=lru["route"],
                      launches_train_4_steps=train["launches_per_4_steps"]["rglru_scan"],
                      launches_elastic=elastic_launches("rglru_scan"),
                      launches_sp_train_shares=[r["launches_shares"]["rglru_scan"]
                                                for r in sp_train["shares"]],
                      rnn_split_per_rank=[{key: c[key] for key in RNN_SCAN_KEYS}
                                          for c in lru_checks if c["case"] in RNN_SCAN_CASES],
                      launches_rnn_split_shares=[
                          [r["model_ranks"], r["form"], r["dtype"],
                           r["launches_shares"]["rglru_scan"]] for r in rnn_split["shares"]],
                      launches_rnn_split_prefill_1_rank=rnn_split["path"]["serve"][
                          "prefill_launches_sharded"]["rglru_scan"],
                      launches_rnn_split_decode_16_steps=rnn_split["path"]["serve"][
                          "decode_launches_sharded"]["rglru_scan"],
                      launches_rnn_split_train_2_steps=rnn_split["path"]["train"]["sharded"][
                          "launches"]["rglru_scan"],
                      launches_rnn_split_serve_2d_prefill_1_rank=rnn_split["path"]["serve_2d"][
                          "prefill_launches"]["rglru_scan"],
                      launches_rnn_split_serve_2d_decode_16_steps=rnn_split["path"][
                          "serve_2d"]["decode_launches"]["rglru_scan"],
                      launches_rnn_grid=[
                          [r["grid"], r["run"], r["dtype"], r["launches"]["rglru_scan"]]
                          for r in rnn_split["grid_shares"]],
                      bf16_a_fp32_b_ms=lru_mixed["ms"], bf16_a_fp32_b_bound_ms=lru_mixed["bound_ms"],
                      bf16_a_fp32_b_plain_ms=lru_mixed["plain_ms"]),
        kernel_record("wkv6", "cuda", "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
                      "src/repro/kernels/rwkv6/rwkv6.py:67",
                      rwkv6["launches"]["wkv6"], wkv, wkv_checks,
                      decode_step_graph_ms=wkv_checks[1]["graph_ms"],
                      rwkv_split_per_rank=[{key: c[key] for key in RWKV_WKV_KEYS if key in c}
                                           for c in wkv_checks
                                           if c["case"] in {n for n, *_ in RWKV_WKV_CASES}],
                      launches_rwkv_split_shares=[
                          [r["model_ranks"], r["dtype"], r["launches_shares"]["wkv6"]]
                          for r in rwkv_split["shares"]],
                      launches_rwkv_split_prefill_1_rank=rwkv_split["path"][
                          "prefill_launches_sharded"]["wkv6"],
                      launches_rwkv_split_decode_16_steps=rwkv_split["path"][
                          "decode_launches_sharded"]["wkv6"],
                      launches_rwkv_split_train_2_steps=rwkv_split["train_path"]["sharded"][
                          "launches"]["wkv6"],
                      launches_rwkv_split_serve_2d_prefill_1_rank=rwkv_split["path_serve_2d"][
                          "prefill_launches_sharded"]["wkv6"],
                      launches_rwkv_split_serve_2d_decode_16_steps=rwkv_split[
                          "path_serve_2d"]["decode_launches_sharded"]["wkv6"],
                      launches_rwkv_grid=[
                          [r["grid"], r["run"], r["dtype"], r["launches"]["wkv6"]]
                          for r in rwkv_split["grid_shares"]]),
    ]
    need(all(kern["launches"] > 0 for kern in kernels), "a kernel did not run on its path")
    summary = {"gpu": smi, "build_s": secs, "serve": serve, "model_check": check,
               "gemma2": gemma2, "rwkv6": rwkv6, "rwkv6_check": rwkv6_check,
               "moe_serve": moe_serve, "moe_check": moe_check,
               "whisper_serve": whisper_serve, "whisper_check": whisper_check,
               "whisper_train_check": whisper_train_check, "whisper_train": whisper_train,
               "whisper_tp_train": whisper_tp_train, "whisper_tp_serve": whisper_tp_serve,
               "train": train, "train_check": train_check,
               "rwkv6_train_check": rwkv6_train_check, "moe_train_check": moe_train_check,
               "train_lm": train_lm_rec, "phase_seconds": phase_s,
               "dispatch": dispatch, "elastic": elastic, "vlm_serve": vlm_serve,
               "tp_serve": tp_serve, "tp_train": tp_train, "sp_train": sp_train,
               "rnn_split": rnn_split, "rwkv_split": rwkv_split, "ep": ep,
               "vlm_check": vlm_check, "dryrun_check": dryrun_rec, "perf_check": perf_rec}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps({"kernels": kernels, **summary}, indent=1) + "\n")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
