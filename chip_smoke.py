#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths (the CNN and
the ViT) on one GPU and check them.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each:

1. env        — the card (nvidia-smi name and power limit), torch and CUDA
                versions, TF32 off;
2. build      — every kernel under pytorch_mnist_ddp_tpu_torch/csrc/, one
                nvcc per source, all started together, loaded as the
                wrappers do at first use; ptxas's registers, spills and
                target per kernel (each must be sm_90a); int8_head's
                cluster size at each timed n and how many such clusters
                the card runs at once (cudaOccupancyMaxActiveClusters);
3. kernel     — each kernel against its plain PyTorch version on the card:
                int8_head equal bit for bit (torch.equal) at the row counts
                the serving ladder gives it, a row-tile boundary (16, 17),
                the edge cases of tests/test_torch_quant.py (a zero row,
                ties, negative ties), one off-model shape whose last
                K-slice is ragged (k = 1040 at n = 5 and 130), and the
                shapes past one K-pass or one h-tile the JAX kernel takes
                (in = 100, 9215, 20000, 36864; hidden = 384, 2048 at
                in = 9216; x one float off alignment),
                adadelta in both modes at flat lengths up to the model's,
                flash_attention in both modes (fwd; partial from the empty
                and from a random state, and in place) at the ViT's shapes,
                odd shapes, q/k/v one element off alignment, d = 128, and
                long ones, with the share of the gate each quantity uses; at
                the longest, kernel and plain version against the fold in
                f64; in bf16 at the ViT's and the long shapes and one
                element off; at d = 160 and 256 in both dtypes;
4. engine     — InferenceEngine.from_seed on the card (f32 + int8),
                bucketed and packed: warmup, the int8 parity gate, f32
                against the CPU model, int8 predictions through the kernel;
5. server     — make_server on 127.0.0.1 over the bucketed engine: JSON
                /predict in f32 and int8 from one client, each answer held
                against engine.predict_logits; /metrics, /healthz, /readyz;
                drain.  Then over the packed engine with concurrent
                clients, so requests coalesce into multi-segment batches;
5b. serving_stack — the single-engine serving stack: a registry of two
                seeded versions in a temporary directory, one packed
                server from its default (--dtypes f32,bf16,int8
                --int8-impl pallas --response-cache 256, telemetry on):
                (a) the bf16 and int8 gates pass, each variant's /predict
                within HTTP_TOL of predict_logits; (b) an --int8-impl dot
                engine's log-probs within DOT_TOL of pallas', its head
                torch.equal to the kernel's, row 1 launched 0 times; (c)
                a binary-wire answer the JSON answer's bytes; (d) 16
                concurrent identical requests one dispatch, a repeat a
                cache hit launching nothing; (e) with the dispatch held at
                a hang fault, batch requests fill the queue and
                interactive arrivals shed batch ones (a check), then a
                round of both classes (p50/p99 a reading); (f) a 25%
                canary serves exactly the rows canary_assignment picks,
                rollback restores v1, a swap under 8 clients tears and
                drops nothing (each answer v1's or v2's bytes) and moves
                the manifest's default, and the swap invalidated the
                cache; (g) a request split across two packed batches
                equals its unsplit answer bit for bit; (h) faults
                installed in-process at launch and complete fail only
                their batch (500), the next request served; (i) a
                --syncbn archive served at f32 (CPU model within F32_TOL)
                and bf16, int8 refused.  Row 1 launches on the path equal
                warmup + gate + split + the int8 batches the telemetry
                records;
5c. pool      — the replica pool (serving/pool.py): two replicas of the
                full-width CNN on cuda:0, each on its own CUDA stream,
                --dtypes f32,int8 --int8-impl pallas, telemetry on; a
                bucketed pool (the CLI's default) and a packed one
                (--packed: a row's answer does not depend on its
                batch-mates): (a) the int8 gates pass, each replica's
                predict_logits on a 128-row batch equal (np.array_equal)
                to a single engine's in f32 and int8, JSON answers within
                HTTP_TOL from one client, bucketed and packed; (b) under
                each router policy 8 closed-loop clients on the packed
                pool, every request one answer within HTTP_TOL, the
                decision counters summing to the requests; the bucketed
                pool under cost and the same 8 clients, each request on
                rows of its own and held within HTTP_TOL to a single
                engine's answer at the bucket its batch was served in
                (each launched batch's rows replayed on it; the buckets
                launched are those the serving_batch events name); (c)
                under cost, r1
                drained at a
                quarter of the traffic and added back at half: nothing
                lost or duplicated, the add ran no warmup rung and loaded
                no kernel library; (d) a launch fault kills r1: the
                supervisor quarantines it, restarts it around its warm
                engine (no rung, no library), its circuit goes open,
                half-open, closed, every request answered once (the
                server resubmits flushed ones); a second schedule past
                the restart budget ejects r1 and r0 serves on; (e) r0's
                read-back hangs, the hedge on r1 wins, the hedge counters
                say won 1 and one dispatch; (f) 256 rows split over both
                replicas equal the single engine's rows, 300 are refused
                (two replicas x 128 rows is the pool's capacity); (g) a
                swap to v2 under 8 clients drops and tears nothing, a
                cache hit launches nothing.  Readings: client p50/p99
                with one and two replicas under the same 8 clients, how
                long kernels of the two streams overlapped in a profiled
                window, row 1 a call at n = 128 on one stream and on the
                two replicas' streams in turn.  Row 1's launches on the
                path equal the int8 dispatches the replicas' engines
                took, and the int8 batches the telemetry records for r0
                and r1, summed, up to the batches a supervisor abort
                caught in flight (at most 3 an abort);
5d. sharded   — sharded replicas (serving/sharded.py) on the one card
                through an explicit device list (``devices=[cuda:0] * k``:
                the k shards run one after another on the card, each on a
                stream of its own; a correctness run, not a sharding
                speed): EnginePool.from_seed(12) of tp4 and pp2 (the CNN),
                vtp4 (ViTConfig()), ep2 (4 experts, capacity factor 4.0)
                and JAX's mixed tp4,dp at the default ladder; every
                sharded replica passes its parity gate at
                SHARDED_PARITY_TOL at warmup (pp at 0.0 against the
                single-device forward a microbatch at a time); one
                closed-loop client sends requests of 1..12 rows through the
                router, each answer held to a single-device engine at the
                bucket it was served in (the dp CNN engine for tp and a dp
                replica, the family's single-device forward for vtp, ep
                and pp) within its kind's tolerance, argmax identical; the
                serving CLI's --replicas 2 --replica-shapes tp2,dp exits 2
                with the JAX planner's error (one card); no kernel
                launches on the path (f32 only).  Readings: each gate's
                gap, the smallest top-1 margin of the parity slice, ep's
                expert_load and imbalance after the requests, pp's gap
                against the whole-bucket forward, ms a 128-row batch
                beside the dp engine's (or the family's single-device
                forward's) on the same card;
6. train_step — 20 train steps from one set of weights on fixed batches,
                dropout off, deterministic cuDNN, three times: the plain
                update, the fused kernel (per-parameter state) and the
                delta kernel (flat state); all three must agree; then the
                delta kernel's twice without deterministic cuDNN (whether
                they repeat bit for bit);
7. train      — the trainer's fit() on the synthetic 60k/10k sets at the
                CLI defaults: two epochs with --pallas-opt (StepLR's
                second lr reaches the kernel), then one epoch plain;
8. resume     — fit() with --pallas-opt: two epochs, against one epoch
                with --save-state and one with --resume-state (params,
                both accumulators and step torch.equal, the resumed log
                the uninterrupted run's epoch 2); at --train-limit, a
                per-leaf archive resumed with --pallas-opt (the delta
                kernel on restored state, once per step) and a flat one
                without; --resume of a --save-model file at --epochs 0;
                seconds per epoch and archive bytes;
9. cnn_variants — 20 steps of --conv-impl im2col_c1 and im2col against
                conv (dropout off, deterministic cuDNN, TF32 off), and two
                epochs of --bf16 --pallas-opt (epoch-1 accuracy floor)
                beside resume's two f32 epochs;
9b. fused     — the fused path (--fused, parallel/fused.py: the dataset
                on the card, each step replayed from one CUDA graph) and
                the prefetch (--prefetch-depth): (a) 2 eager and 20
                replayed fused steps against 22 per-batch steps on the same
                batches from the same weights, dropout on, plain and
                --pallas-opt, torch.equal, row 3 once a replay; (b)
                mnist.py --fused --pallas-opt for two epochs torch.equal to
                the train phase's two per-batch epochs, lines identical,
                epoch-1 accuracy floor, s/epoch both ways, host reads an
                epoch; --fused --pregather equal to --fused at
                --train-limit; (c) --prefetch-depth 0 equal to 2 at
                --train-limit, s/epoch and median data_wait_seconds each;
                (d) mnist_ddp in an NCCL world of one through the launcher
                (this script the rank program): --fused --pallas-opt
                --save-model equal to (b), --fused --zero and --fused
                --syncbn --pallas-opt equal to their per-batch runs (two
                gloo ranks sharing the card refused with the NCCL
                ValueError: in the ddp phase's gloo world); (e) 100
                replayed steps under torch.profiler;
10. ddp       — mnist_ddp on the card: an NCCL world of one through the
                launcher (--nproc_per_node=1, --batch-size 200 --pallas-opt
                --save-model, one epoch; this script is the rank program, so
                it can read the rank's launch counts): the banner, epoch-1
                accuracy, row 3 once a step, and mnist_cnn.pt (module. keys)
                torch.equal to mnist.py's fit() with the same flags; then
                20 profiled steps of that world's step in this process
                (the all-reduce's own time); and two ranks sharing the card
                over gloo, 20 fixed steps plain, --pallas-opt and --syncbn
                --pallas-opt: the ranks equal, within the CPU trajectory
                gates of one rank at twice the batch (over all 20 steps
                with --syncbn, over the gates' 8 without), and without
                BatchNorm equal bit for bit to the same steps computed in
                one process and, after 20 steps, no farther from their f64
                run than an order of magnitude times the farthest of the
                one rank's own f32 orders; then --zero and --zero --syncbn
                on the two ranks, bit for bit the plain data-parallel
                steps they shard, and --zero in an NCCL world of one
                through the launcher equal to the plain run (model, lines,
                --save-state archive), archives crossing between --zero and
                plain runs resumed equal (the plain archive under --zero
                in this process);
11. times     — each kernel, its plain version and the nearest library
                call, with CUDA events, beside the least time the card
                could take; adadelta with the L2 flushed before each call;
                int8_head at n = 1, 8, 128 per call and back to back (100
                calls between one pair of events, as for a one-element
                add_), beside torch._int_mm on its rows zero-padded to 17
                with fc1's weight as a row-major copy and as the
                column-major view; and at n = 8 at the shapes past one
                K-pass or h-tile;
12. train_profile — where a training step's time goes: the loader alone,
                then 20 steps, plain and --pallas-opt, under
                torch.profiler (wall and device-busy time per step), and
                --pallas-opt again without deterministic cuDNN and under
                --bf16 with and without it; seconds for 100 of the
                --pallas-opt steps with and without it, in turns;
13. vit_step  — the ViT (vit_mnist.py defaults), 20 train steps from one set
                of weights on fixed batches, seven ways: plain, --flash,
                --sp 1 --allow-degree-1 --flash, --flash --remat, and with
                --bf16 plain, --flash, --sp 1 --allow-degree-1 --flash; each
                dtype's runs must agree and launch the kernel once per
                attention call;
14. vit_train — the ViT CLI's fit() at the CLI defaults: one epoch each
                of --flash and --bf16 --sp 1 --allow-degree-1 --flash on
                the synthetic sets (epoch-1 accuracy floor) and of --sp 1
                --allow-degree-1 --flash and --bf16 --flash cut to 100
                steps, launches equal to the attention calls;
14b. vit_fused — the ViT's --fused (parallel/fused_vit.py): (a)
                WARMUP_STEPS eager and 20 replayed steps torch.equal (losses,
                parameters, accumulators) to as many per-batch steps on the
                loader's batches from the same weights, plain, --bf16,
                --remat and --zero (a world of one); (b) vit_mnist.fit
                --fused --timings-json for one full epoch at the CLI
                defaults (epoch-1 accuracy >= 70%, one host read, 936
                replays, every timings key, compile_s > 0, 0 < run_s <
                wall), and on vit_train's 100-step cut: --fused and
                --pregather torch.equal to the per-batch epoch, lines too,
                and the CLI's --fused --zero --save-state in an NCCL world
                of one through the launcher, its lines and archive the
                per-batch epoch's; (c) tools/vit_bench.py --mode fused
                --epochs 1, one JSON line with mfu in (0, 1); (d)
                VIT_FUSED_PROFILE_STEPS replays under torch.profiler; no
                kernel of the table launched;
15. vit_profile — where a ViT step's time goes: 10 steps, plain, --flash,
                --sp 1 --allow-degree-1 --flash and --bf16 --flash, under
                torch.profiler;
16. times     — flash_attention in both modes and both dtypes, its plain
                version and scaled_dot_product_attention (and the backend
                it picks) in the same dtype, at the ViT's and long shapes
                and at d = 160 and 256;
                beside them the share of the bound, the ratio to SDPA and
                (f32) the CUDA-core bound, and a one-element add_ as launch
                floor;
17. vit_parallel — the ViT's --sp, --sp-impl ulysses, --tp and --sp --tp:
                (a) the ring over S token shards of one sequence in this
                process (the shards' k/v rotated as the ring passes them),
                S = 2 and 4 at the ViT's train shape, 2 at its eval shape,
                4 at (1, 8192, 2, 64), f32 and bf16, with and without
                autograd (the state in place from hop to hop), held to the
                plain ring and to the whole-forward kernel on the whole
                sequence, and row 5's time per hop; (b) an NCCL world of
                one through the launcher (this script is the rank program):
                20 fixed steps of --sp 1 --tp 1 --allow-degree-1 --flash and
                of --sp 1 --allow-degree-1 --flash, the latter torch.equal to
                the same steps through vit_mnist's builder without a
                launcher, and the same flags through vit_mnist's CLI under
                the launcher for one 20-step epoch on an IDX data root,
                line for line and byte for byte in the saved archive the
                same as vit_mnist.fit() without a launcher; (c) two gloo
                ranks sharing the card (the ring passes staged through the
                host, counted), 20 steps of --sp 2, --sp 2 --sp-impl ulysses and
                --tp 2, each with --flash and also --bf16, and (d) four, of
                --sp 2 --tp 2 --flash, each held to the single-device
                --flash steps of its dtype with the ranks' replicated
                leaves bit-equal after every step and the flash launches
                at their formula; (e) one 100-step epoch of --sp 2 --flash
                on the two ranks through vit_mnist.fit (ms a step, host µs
                a ring pass, launches and staged passes at their formula);
18. vit_family — the ViT's --experts, --zero and --pp: (a) an NCCL world
                of one through the launcher, 20 fixed steps of --experts 8
                --flash (twice: the repeat bit for bit) and --zero --flash,
                torch.equal to vit_mnist's builder without a launcher,
                --zero also to the single-device --flash steps, no
                collective called; (b) two gloo ranks sharing the card,
                --experts 8 --flash (4 experts a rank, both all-to-alls
                real), --zero --flash and --pp (2 stages, 2 microbatches,
                the boundary staged through the host and counted), f32
                and --bf16; (c) four: --experts 8 --flash and --pp on a
                2 x 2 grid; each leg's replicated leaves bit-equal on every
                rank after every step, held at the trajectory gates to
                its reference here (the MoE legs to the same routing
                groups in one process, --zero to the single-device --flash
                steps, --pp to the single-device plain steps), the MoE
                legs' routing flips and smallest gate margin recorded;
                (d) one --experts 8 --flash epoch through vit_mnist.fit
                in this process while (a)-(c)'s processes run (epoch-1
                accuracy floor, ms a step, row 4 at its formula);
19. train_state — 20-step epochs on a seeded IDX set, TF32 off: (a) the
                ViT's --save-state then --resume-state, --flash and --sp 1
                --allow-degree-1 --flash, torch.equal to two epochs without
                a break (params, accumulators, step; the archives byte for
                byte), rows 4 and 5 once an attention call; (b) two gloo
                ranks sharing the card: a mid-epoch --pallas-opt archive
                (mnist_ddp's step, dropout off), mnist_ddp --tp 2 and --pp
                (f32, --bf16), 20 fixed steps from SEED held to the
                one-process data-parallel steps (the first 8 at the ddp
                phase's gates, bf16 at 5e-3), and --tp 2 --save-model
                writing the gathered state; (c) four: --tp 2 on 2 x 2;
                (d) an NCCL world of one through the launcher (this script
                the rank program): --zero --flash saved and resumed equal
                to two epochs, a plain archive resumed under --zero and a
                --zero archive without it (archives byte for byte), and the
                two ranks' archive resumed with --resume-reshard within the
                trajectory gates of their own epoch (without the flag, the
                JAX trainer's refusal); (e) the CNN's --elastic: --epochs
                1, then 2 (torch.equal to two epochs), then 2 again (no
                step); (f) --profile --step-stats on a --pallas-opt CNN
                epoch and a ViT --flash epoch: the Chrome trace parses and
                names row 3's and row 4's kernels once a launch, one
                step-stats line an epoch, trace bytes and wall seconds
                beside the unprofiled epoch;
20. resilience — the resilient runtime, telemetry and the launcher's gang
                restart on the reference CNN at full width with
                --pallas-opt, on 19's IDX set (20-step epochs at batch
                64), TF32 off: (a) two epochs with --telemetry-dir,
                --save-state and --checkpoint-every-steps 7; (b) the same
                run with --chaos kill:step:after=13 in a process of its
                own exits 137, and --resume-state gives (a)'s final
                archive array for array, the two runs' step events
                (epoch, step, loss) (a)'s; (c) kill:ckpt_save:after=1
                exits 137 with only the .prev rotation, which resumes to
                (a); (d) --loss-guard under nan:step:after=5 equals (a)
                (torch.equal), one train_anomalies_total{kind="nan"},
                row 3 launched once more than in (a); (e) the launcher
                with --nprocs 1 --restart-budget 1 over mnist_ddp
                --batch-size 200 in an NCCL world of one killed by
                kill:step:rank=0:after=9 exits 0 with one restart
                (launch_restarts_total 1, rank_death and gang_restart
                events, both incarnations' rendezvous attempts) and the
                final archive of an uninterrupted run; (f) one --fused
                --pallas-opt --telemetry-dir epoch: the counters equal the
                steps and samples, one host read; readings: ms a step of
                the guarded, telemetered run beside the flagless one (both
                before the child processes start), a snapshot's device
                time, checkpoint_write_seconds, the restart's wall
                seconds;
21. compile   — the startup path (compile/: the kernel-library store
                behind --aot-cache, Programs, the startup overlap) on a
                store made fresh under the work directory, in processes
                of their own on 20's IDX set, this script their wrapper
                (``--compile-cli`` runs a CLI's body and writes what only
                that process sees: nvcc runs, libraries loaded and where
                from, their sha256, launches, the seconds from its start
                to its first "Train Epoch" or "warmup verified" line):
                (a) cold: mnist --epochs 1 --pallas-opt --aot-cache D
                --serve-prewarm --save-model gives miss for adadelta and
                int8_head and runs nvcc twice, while this process runs
                the flagless and flagless --fused references (their
                library the build directory's store, the build phase's);
                then, together: (b) the same
                command again: hits only, no nvcc run, the libraries (a)
                built (same sha256), its stdout and mnist_cnn.pt byte-equal
                to (a)'s and the flagless run's, row 3 once a step; (b')
                --fused --pallas-opt --aot-cache D: a hit, its stdout the
                flagless --fused run's, its startup_overlap_ratio
                recorded; (c) in a process of its own
                (``--compile-serve``, on a host without nvcc: neither
                PATH nor CUDA_HOME finds one) the serving CLI's main with
                --warmup-only --dtypes f32,int8 --aot-cache D loads
                int8_head as a hit and runs nvcc 0 times, then an engine
                answers at every bucket; in another (no nvcc either) a
                --replicas 2 pool on D loads it as a hit, and each replica's int8 answers are
                the engine's (np.array_equal); (d) the engine on a copy of D
                whose int8_head header was tampered, and on another copy
                with fail:aot_load:count=1 installed in its process: each
                a fallback, nvcc once, the entry rewritten (a new library
                file, its header this environment's, its sha256 the
                file's), every answer the handoff engine's; (e) a second
                pool warmed with --serial-warmup (the replicas in turn)
                answers as the first, and an engine with
                --no-device-stage as the default engine, at every rung
                (f32 and int8).  Row 1
                launches on the path = the int8 rungs, gates and answers
                the processes ran (plus the CLI's rungs and gate), row 3's
                = the runs' steps.  Readings: seconds to torch imported,
                to the card's context, to the first step and to an
                engine's warmup end, cold and warm,
                compile_seconds_total per program, each library's load or
                build seconds, the fused run's overlap ratio;
22. fleet     — the serving fleet (serving/fleet.py): ``python -m
                pytorch_mnist_ddp_tpu_torch.serving --fleet 2 --dtypes
                f32,int8 --int8-impl pallas --aot-cache D`` on 21's store
                D, a process of its own on a host without nvcc (neither
                PATH nor CUDA_HOME finds one; the backends and every
                replacement inherit that), seed-12 weights, beside it a
                --fleet 1 for (c): (a) every backend active with
                compiles 0, its int8 gate passed and int8_head a store hit
                with 0 nvcc builds; 16 seeded requests one at a time to
                each front, f32 and int8, JSON and the binary wire, each
                answer equal (np.array_equal) to a single engine's in this
                process at the same bucket; (b) b1 SIGKILLed under 8 closed-loop
                clients: every request one 200, b1 replaced in a new
                process that builds nothing (compiles 0),
                fleet_backend_restarts_total{backend="b1"} 1; (c) at
                once, the fleet of one's b0 SIGSTOPped: its heartbeat
                goes stale, the supervisor's incident says so and b0 is
                replaced; both fronts exit 0 on SIGTERM.  Every answer
                under load within HTTP_TOL (same argmax) of the single
                engine's for its rows at one of the ladder's buckets.
                Readings: each backend's and front's seconds to ready,
                client p50/p99 of (b), the seconds from the kill and the
                stop to the replacement being active (the throughput
                readings with one and two backends are 23 (c)'s);
23. loadgen   — the port's operator tools (``python -m
                pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen`` and
                ``.tools.slo_gate``) on 22's store D, in the same work
                directory, on a host without nvcc; three parts started
                together: (a) the SLO gate in a process of its own on
                cuda:0 (its committed protocol: two dp replicas on their
                own streams, packed, the steady, recovery and swap rounds,
                each a loadgen process): exit 0, every budget met, its
                verdict row appended to build/loadgen/BENCH_slo.json, no
                library built; (b) in this process, a two-replica pool of
                --dtype int8 --int8-impl pallas off D under 8 closed-loop
                clients for 3 s (the pool's rate R), then --ab-tail at an
                offered 1.2 R, --qos-mix interactive=0.8,batch=0.2: no
                lost or duplicated response, the compile firewall held
                in both rungs; (c) --fleet-sweep 1,2 on real backend
                processes off D (--dtype int8 --int8-impl pallas, an
                open-loop 100 requests/s), with its kill round: lost 0,
                transport errors 0, the front's compiles 0 in every rung,
                the killed backend replaced with compiles 0, and every
                backend process a store hit with 0 nvcc builds.
                Readings: (b)'s closed-loop rate and p50/p99 and the
                per-class p50/p99 with QoS off and on; (c)'s requests/s
                and p50/p99 at 1 and 2 backends and the replacement's
                seconds; (a)'s measured values beside the budgets.

Every phase line carries its ``seconds``.  Then the ``kernels`` line, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  Launch
counts are zeroed just before each main path and read just after it:
int8_head over phases 4-5 (the serving path) and again over 5b (the
serving stack; its references apart), adadelta over phases 6-9
(the CNN training path, resumed runs included), again over 9b (the fused
and prefetching paths, the launcher rank's included; the per-batch
references apart) and again over phase 10 (the data-parallel step, the
ranks' processes included; the references it is held to are counted
apart), flash_attention over phases 13-14 (the ViT training path) and
again over 17 (b)-(e) (the parallel modes, counted by the ranks'
processes; the single-device references apart; (a)'s launches compare
and are not counted) and over 18 (the ranks' processes and the epoch;
the references apart); flash_attention and adadelta again over 19 (the
ranks' and the launcher's processes included; the uninterrupted runs the
resumed ones are held to apart); adadelta again over 20 (this process's
runs; the killed processes and the launcher's rank count nothing, the
flagless and uninterrupted references apart); int8_head and adadelta
again over 21 (counted by its processes; the flagless runs apart);
int8_head again over 22 (each backend process's own count, written to a
file by LAUNCH_COUNTER_SITE; a SIGKILLed process loses its last 50 ms;
a SIGTERMed one's must equal its telemetry's int8 rungs, gate and int8
batches; the reference engine apart); int8_head again over 23 ((b)'s in
this process, (a)'s and (c)'s processes' own counts as in 22).
Latencies, seconds per epoch and images/s are smoke readings of this
script's own work, not a benchmark.  Any failure exits non-zero; so does a host
without a CUDA device.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

PROCESS_START = time.perf_counter()  # the compile phase's processes time from here

# InferenceEngine.from_seed weights (torch.Generator).  Random weights give
# near-uniform logits, and the int8 gate rightly refuses argmax ties inside
# the quantization error; seed 12's smallest top-1 margin over the 128-row
# parity slice is ~0.1, against an int8 error of ~0.005 (CPU scan).
SEED = 12
# int8_head is held to its plain version with torch.equal: the same integer
# arithmetic and the same IEEE epilogue, whatever the split of K.
KERNEL_ROWS = (1, 3, 8, 16, 17, 64, 128, 130)
HEAD_EDGE_CASES = ("zero_row", "ties", "negative_ties")
HEAD_RAGGED = (1040, 128, 10)  # k, h, o: the last K-slice ends inside a chunk
HEAD_RAGGED_ROWS = (5, 130)
# (k, h): shapes the JAX kernel takes past one K-pass (k > 18432 at 16
# ranks), with k not a multiple of 16 (or of 4), and hidden in several
# 128-column tiles, through device memory at 2048 (rank 0's shared memory
# would overflow).
HEAD_SHAPES = ((100, 128), (9215, 128), (20000, 128), (4 * 9216, 128), (9216, 384), (9216, 2048))
HEAD_SHAPES_ROWS = (5, 130)
TIMED_ROWS = (1, 8, 128)
BACK_TO_BACK_CALLS = 100
INT_MM_MIN_ROWS = 17  # torch._int_mm refuses m <= 16
F32_TOL = 1e-4  # cuDNN vs CPU f32 convs: same math, other summation order
HTTP_TOL = 1e-5  # same rows, same bucket shape, same device as predict_logits
# Latency loop: one client, closed loop (next request after the reply),
# sizes 1..12 rows alternating f32/int8; 1000 samples leave 10 beyond p99.
LATENCY_REQUESTS = 1000
# Packed server: one round per dtype, each of CLIENTS closed-loop clients
# sending PER_CLIENT requests of 1..12 rows.  One dtype per round: the
# batcher closes a batch at the first queued request of another dtype, and
# on the card mixed traffic dispatched every request alone (PERF.md).
CLIENTS = 8
PER_CLIENT = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core peak
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
# Adadelta: flat lengths from one element to the model's 1,199,882, and
# one buffer offset by one element, which takes the kernel's scalar path.
ADADELTA_N = (1, 37, 1024, 33000, 300000, 1199882)
ADADELTA_TOL = 1e-6  # kernel vs plain: same IEEE ops in the same order
TRAIN_STEPS = 20  # train_step phase
PROFILE_STEPS = 20  # train_profile phase
# A torch.profiler window drops the device records of the first launches
# it sees: none in a fresh process, more as the process goes on, always
# the first ones (fused (e) once read row 3 97 times in 100 replays).  So
# each window first launches PROFILE_PREFIX_KERNELS sleep kernels, which
# take the loss (profile_window's prefix_records_lost) and are left out of
# its counts, and idles PROFILE_MARGIN_S before its first step and after
# its last.
PROFILE_PREFIX_KERNELS = 2048
PROFILE_MARGIN_S = 0.1
# Host events that put work on the device, each with the correlation id
# of the device records it made.
LAUNCH_EVENTS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")
SLEEP_KERNEL = "spin_kernel"  # torch.cuda._sleep's
# vit_profile phase: a ViT step holds ~960 device and ~7,000 host events,
# and reading a 100-step window back took ~50 s a way (PR 12); 20 steps
# give the same per-step readings.  The windows are readings, and reading
# them back is most of their phases' time, so 10 ViT steps (20 before),
# and 20 CNN steps in train_profile and ddp (100, then 40 before; cut when
# the sharded phase came), keep the time.
VIT_PROFILE_STEPS = 10
# train_profile's determinism cost: the --pallas-opt steps over this many
# of an epoch's batches, with and without deterministic cuDNN, in turns
# (300 before the fleet phase came; a reading).
ABBA_STEPS = 100
TRAIN_STEP_RTOL = 1e-5  # three optimizer paths, deterministic cuDNN
EPOCH1_MIN_ACCURACY = 0.95
# ddp phase: the reference's headline batch (README.md:42) in an NCCL world
# of one; two gloo ranks on one card, DDP_STEPS fixed steps each way at
# DDP_RANK_BATCH a rank, held to one rank at twice the batch within the
# CPU trajectory gates of tests/test_torch_train.py.
DDP_BATCH = 200
DDP_PROFILE_STEPS = 20
DDP_STEPS = 20
DDP_RANK_BATCH = 32
DDP_WAYS = (("plain", False, False), ("pallas_opt", True, False),
            ("syncbn_pallas_opt", True, True))
DDP_LOSS_RTOL, DDP_LOSS_ATOL, DDP_PARAM_ATOL = 2e-4, 2e-5, 5e-3
# --zero on the two gloo ranks: each way against the plain data-parallel way
# it shards (the same steps, bit for bit: gloo's reduce-scatter sums the
# two ranks' gradients as its all-reduce does).  (way, syncbn, zero)
DDP_ZERO_WAYS = (("zero", False, True), ("zero_syncbn", True, True),
                 ("plain_syncbn", True, False))
DDP_ZERO_HELD_TO = {"zero": "plain", "zero_syncbn": "plain_syncbn"}
# --zero in the NCCL world of one: --train-limit rows, one epoch at batch 200
DDP_ZERO_LIMIT = 6400
# The runs without BatchNorm are gated at the gates' own horizon (the 8
# steps of tests/test_torch_train.py), --syncbn over all DDP_STEPS.  Past 8
# steps the runs without BatchNorm part ways on the card: at lr 1.0 a
# summation order's last-ulp differences (one rank's batch of 64 against two
# of 32) stay within 5e-6 of the loss for 15 steps, then grow about tenfold
# a step (1.4e-2 at step 20).  What holds them there: the ranks equal the
# same steps computed in one process bit for bit, and against an f64 run of
# the one-rank steps they are no farther after DDP_STEPS than DDP_F64_RATIO,
# an order of magnitude, times the farthest of the one rank's own f32
# orders: its batch as it comes and DDP_ORDERS permutations of its rows,
# the same math summed in other orders (both runs: tools/ddp_f32_orders.py).
# That tool finds the two ranks' order 6.83e-3 (params) and 1.43e-2 (loss)
# from f64 after 20 steps, 4 of 32 row permutations of the one rank's batch
# 6.84e-3-6.86e-3 and 1.43e-2-1.48e-2, the rest 4.8e-7-1.0e-3 (NVIDIA H100
# 80GB HBM3, 700.00 W).
DDP_GATE_STEPS = 8
DDP_ORDERS = 4
DDP_F64_RATIO = 10.0
# Epoch-1 test accuracy of --batch-size 200 --pallas-opt at the CLI's seed:
# one epoch is 300 steps, and where it ends depends on the seed.
# tools/epoch1_accuracy.py on NVIDIA H100 80GB HBM3, 700.00 W, seeds 1-40:
# the port reads 90.96% at seed 1, 95.89% on average, under 95% at 10
# seeds and under 93% at 3; a witness that shares nothing with the port but
# the data (the upstream PyTorch example, --impl reference) reads 95.85% on
# average, under 95% at 8 seeds and under 93% at 3, 92.79% at worst.  So 95% at one seed is no
# property of the reference program; the floor sits below the lowest
# reading of either.
DDP_EPOCH1_MIN_ACCURACY = 0.90
# resume phase, legs (c) and (d): 100 steps an epoch at batch 64.
RESUME_LIMIT = 6400
# cnn_variants phase: the im2col lowerings against cuDNN's conv after
# TRAIN_STEPS steps at lr 1.0, dropout off, TF32 off, deterministic cuDNN.
# The same products summed in another order, and Adadelta amplifies the
# last-ulp differences step by step: on the CPU the port's im2col reads
# 1.8e-4 relative in the loss and 1.0e-3 in the parameters after 20 steps
# (the 8-step gate of tests/test_torch_net_variants.py is rtol 2e-4).  A
# wrong patch order is off by more than 1e-1.
VARIANT_LOSS_RTOL, VARIANT_LOSS_ATOL, VARIANT_PARAM_ATOL = 1e-3, 2e-5, 5e-3
L2_FLUSH_BYTES = 256 << 20  # > 5x the 50 MB L2
# Per element: 14 flops for the delta mode, 16 with p -= lr * delta; bytes
# read once and written once: g, sq, ac in and delta, sq, ac out (24), or
# p, g, sq, ac in and p, sq, ac out (28).
ADADELTA_WORK = {"adadelta_delta": (24, 14), "adadelta_fused": (28, 16)}
ADADELTA_REPLACES = {"adadelta_delta": "pytorch_mnist_ddp_tpu/ops/pallas_adadelta.py:140",
                     "adadelta_fused": "pytorch_mnist_ddp_tpu/ops/pallas_adadelta.py:71"}
# Flash attention, (b, t, h, d): the ViT's train and eval batches, the odd
# shapes of tests/test_flash.py, and the long shapes of tools/flash_bench.py.
FLASH_MAIN = {"train": (64, 16, 4, 16), "eval": (1000, 16, 4, 16)}
FLASH_ODD = ((2, 16, 4, 16), (1, 300, 2, 64), (2, 128, 2, 32), (1, 257, 1, 8))
FLASH_LONG = ((4, 512, 4, 64), (2, 2048, 4, 64), (1, 8192, 2, 64))
# q/k/v one float into their allocation (the kernel's 4-byte copies, one
# shape per tile path), and the widest head the wrapper admits.
FLASH_OFFSET = ((64, 16, 4, 16), (1, 300, 2, 64))
FLASH_WIDE = (1, 300, 2, 128)
# Kernel vs plain, f32 both: other summation order, IEEE exp/log/div.  The
# partial mode's accumulator a is an unnormalized sum over t keys, whose
# rounding grows with t (its error against the plain version measured
# 1.4e-6 at t = 16 and 1.7e-4 at t = 8192, NVIDIA H100 80GB HBM3, 700 W):
# it is held as a / l, the output the ring finalizes to, and its raw error
# is recorded.
FLASH_RTOL, FLASH_ATOL = 1e-5, 1e-6
# bf16 (the Pallas kernel's bf16 contract on both sides): f32 quantities
# (lse, m, l) at the f32 gate above; the bf16 output and a / l within about
# one bf16 ulp, 2^-7 relative and 2^-8 absolute.  Both versions round p
# to bf16 against the running max of the key tile it is in, and they tile
# the keys differently (the kernel 16-64 keys, the plain version one fold),
# so some p round apart: measured at most 0.49 of this gate, max |diff| of
# the output 2^-8 (NVIDIA H100 80GB HBM3, 700.00 W).
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -7, 2.0 ** -8
# head_dim past 128, the kernel's slab loop, in both dtypes.  The scores
# sum d products, and both f32 versions round along them, so their
# difference grows with d: past d = 128 the f32 gate is multiplied by d / 64
# (the long shapes' d; 4 at d = 256), and kernel and plain version are held
# against the fold in f64 beside it.
FLASH_WIDE_D = ((2, 16, 4, 160), (1, 300, 2, 160), (2, 16, 2, 256), (1, 200, 2, 256))
FLASH_REPLACES = {"flash_fwd": "pytorch_mnist_ddp_tpu/ops/pallas_attention.py:154",
                  "flash_partial": "pytorch_mnist_ddp_tpu/ops/pallas_attention.py:360"}
VIT_STEPS = 20  # vit_step phase
# Four ViT step paths after 20 steps: the kernel sums in another order than
# the plain attention (measured 2.4e-7 in the loss and 1.2e-7 in the
# parameters, NVIDIA H100 80GB HBM3, 700 W).
VIT_STEP_RTOL, VIT_STEP_ATOL = 1e-5, 1e-5
# The --bf16 runs against the bf16 plain run: the kernel's bf16 contract
# (p rounded to bf16, f32 scores) is not the plain attention's (scores
# rounded to bf16, p unrounded), so the steps drift apart by bf16
# roundings: after 20 steps 5.8e-4 in the loss and 4.6e-4 in the
# parameters (NVIDIA H100 80GB HBM3, 700.00 W).
VIT_BF16_STEP_ATOL = 5e-3
# Epoch-1 test accuracy of the ViT at the CLI defaults: the JAX package's
# vit_mnist.py --no-accel --epochs 1 reads 79.18% (seed 1), 81.00% (seed 2)
# and 79.74% (seed 3) on the CPU, and with --bf16 78.82%, 84.26% and 75.91%;
# the port's initial weights come from another generator, so the floor sits
# 5.9 points below the lowest reading.
VIT_EPOCH1_MIN_ACCURACY = 0.70
# vit_train's --sp 1 --allow-degree-1 --flash (f32) and --bf16 --flash
# epochs, cut to 100 steps of 64: the floor stays on the full epochs of
# --flash (f32) and --bf16 --sp 1 --allow-degree-1 --flash.
VIT_CUT_ROWS = 6400
# vit_parallel's --sp 2 epoch on VIT_CUT_ROWS rows against vit_train's --sp 1
# epoch on them: test rows whose prediction may differ (0 in four H100 runs)
VIT_CUT_CORRECT_SLACK = 5
# vit_parallel phase.  (a) The ring over S token shards of one sequence in
# this process, k/v rotated between the shards as the ring passes them:
# (S, (b, T, h, d)) at the ViT's train and eval shapes and one long one.
VIT_RING_CASES = ((2, (64, 16, 4, 16)), (4, (64, 16, 4, 16)), (2, (1000, 16, 4, 16)),
                  (4, (1, 8192, 2, 64)))
# The kernels' new shapes on the parallel paths, held to their plain
# versions in the kernel phase: per-rank q/k/v of the ring (t = 8, 4), of
# Ulysses and --tp (h = 2, 1), of --sp 2 --tp 2, the long ring's hop, and
# of --experts/--zero on 2 and 4 data ranks (b = 32, 16; vit_family).
FLASH_PARALLEL = ((64, 8, 4, 16), (64, 4, 4, 16), (1000, 8, 4, 16), (64, 16, 2, 16),
                  (64, 16, 1, 16), (1000, 16, 2, 16), (64, 8, 2, 16), (1, 2048, 2, 64),
                  (32, 16, 4, 16), (16, 16, 4, 16))
# (b)-(e): the parallel modes through vit_mnist's builder, VIT_PAR_STEPS
# fixed steps at the CLI's batch (one data shard: every leg's global batch
# is the single device's) against the single-device --flash steps, at the
# trajectory gates the ddp phase uses for f32 (loss rtol 2e-4 / atol 2e-5,
# params atol 5e-3), and for --bf16 at VIT_BF16_STEP_ATOL against the bf16
# single device: the ring folds p rounded per key tile of each shard, the
# whole-forward kernel per tile of the sequence.
VIT_PAR_STEPS = 20
VIT_PAR_LEGS = {
    "flash": ["--flash"],
    "bf16_flash": ["--bf16", "--flash"],
    "sp1_flash": ["--sp", "1", "--allow-degree-1", "--flash"],
    "sp1tp1_flash": ["--sp", "1", "--tp", "1", "--allow-degree-1", "--flash"],
    "sp2_flash": ["--sp", "2", "--flash"],
    "ulysses2_flash": ["--sp", "2", "--sp-impl", "ulysses", "--flash"],
    "tp2_flash": ["--tp", "2", "--flash"],
    "bf16_sp2_flash": ["--bf16", "--sp", "2", "--flash"],
    "bf16_ulysses2_flash": ["--bf16", "--sp", "2", "--sp-impl", "ulysses", "--flash"],
    "bf16_tp2_flash": ["--bf16", "--tp", "2", "--flash"],
    "sp2tp2_flash": ["--sp", "2", "--tp", "2", "--flash"],
    # vit_family: --experts, --zero, --pp, and the single-device plain runs
    # the pipeline is held to (--pp refuses --flash)
    "experts_flash": ["--experts", "8", "--flash"],
    "experts_flash_again": ["--experts", "8", "--flash"],
    "zero_flash": ["--zero", "--flash"],
    "pp": ["--pp"],
    "bf16_experts_flash": ["--bf16", "--experts", "8", "--flash"],
    "bf16_zero_flash": ["--bf16", "--zero", "--flash"],
    "bf16_pp": ["--bf16", "--pp"],
    "plain": [],
    "bf16_plain": ["--bf16"],
}
VIT_PAR_NCCL = ("sp1tp1_flash", "sp1_flash")  # (b) an NCCL world of one
VIT_PAR_TWO = ("sp2_flash", "ulysses2_flash", "tp2_flash", "bf16_sp2_flash",
               "bf16_ulysses2_flash", "bf16_tp2_flash")  # (c) two gloo ranks
VIT_PAR_FOUR = ("sp2tp2_flash",)  # (d) four gloo ranks
VIT_PAR_EPOCH = ["--epochs", "1", "--sp", "2", "--flash"]  # (e) on the two ranks
VIT_PAR_LOSS_RTOL, VIT_PAR_LOSS_ATOL, VIT_PAR_PARAM_ATOL = 2e-4, 2e-5, 5e-3
# vit_family phase, the same steps, batches and gates: (a) an NCCL world of
# one through the launcher; (b) two gloo ranks sharing the card; (c) four;
# (d) one --experts 8 --flash epoch on the single device.  The MoE legs are
# held to the same routing groups (the ranks' row blocks) computed in one
# process, --zero to the single-device --flash steps, --pp (2 stages, 2
# microbatches) to the single-device plain steps.
VIT_FAM_NCCL = ("experts_flash", "experts_flash_again", "zero_flash")
VIT_FAM_TWO = ("experts_flash", "zero_flash", "pp", "bf16_experts_flash", "bf16_zero_flash",
               "bf16_pp")
VIT_FAM_FOUR = ("experts_flash", "pp")
VIT_FAM_EPOCH = ["--epochs", "1", "--experts", "8", "--flash"]
# Epoch-1 test accuracy of --experts 8 at the CLI defaults: the JAX
# package's vit_mnist.py --no-accel --experts 8 --epochs 1 reads 77.46%
# (seed 1), 78.31% (seed 2) and 75.53% (seed 3) on the CPU; the floor
# sits 9.5 points below the lowest reading, as the dense ViT's 70% sits 9.2
# below its 79.18%.  The reading is the seed's: over seeds 1-5, each CLI
# trained from each package's initial weights reads 75.53-85.43%, JAX's
# own 85.43% at seed 5 (tools/vit_epoch1_cross.py, CPU).
VIT_MOE_EPOCH1_MIN_ACCURACY = 0.66
# train_state phase: 20-step epochs on vit_idx_root's IDX set (1280 train
# rows, batch 64).  The --tp 2 / --pp legs (mode, bf16), TRAIN_STEPS fixed
# steps from SEED against the one-process data-parallel steps: over the
# first DDP_GATE_STEPS steps at the ddp phase's gates (the CNN's runs
# without BatchNorm part ways past them at lr 1.0, ddp phase above), bf16
# at STATE_BF16_ATOL; the 20-step differences recorded.  The
# --resume-reshard archive: two ranks of STATE_RANK_BATCH rows save it
# before batch STATE_CURSOR, so the world of one resumes DDP_GATE_STEPS
# steps of 64.
STATE_MP_LEGS = {"tp2": ("tp", False), "tp2_bf16": ("tp", True), "pp": ("pp", False),
                 "pp_bf16": ("pp", True)}
STATE_TWO = ("tp2", "tp2_bf16", "pp", "pp_bf16")
STATE_FOUR = ("tp2",)
STATE_BF16_ATOL = 5e-3
STATE_RANK_BATCH = 32
STATE_CURSOR = 12
# fused phase: (a) WARMUP_STEPS eager and FUSED_CAPTURED replayed steps
# against as many per-batch steps; (b)-(d) --train-limit legs on an IDX set
# of FUSED_LIMIT training rows (100 steps of 64); (e) profiled replays.
FUSED_CAPTURED = 20
FUSED_LIMIT = 6400
FUSED_PROFILE_STEPS = 100
# vit_fused phase: (a) as fused's, (d) profiled replays
VIT_FUSED_CAPTURED = 20
VIT_FUSED_PROFILE_STEPS = 10
# resilience phase: the checkpoint cadence and (b)'s kill, in steps
RESILIENCE_CKPT = 7
RESILIENCE_KILL_AFTER = 13
# serving_stack: the registry's second version and the --syncbn archive,
# seeded (CPU scans: int8 top-1 margin ~0.14 on the parity slice for v2,
# bf16 margin ~0.13 for the BN model, against gate errors of ~0.004)
STACK_V2_SEED = 18
STACK_BN_SEED = 16
STACK_CACHE = 256  # --response-cache
STACK_QUEUE_DEPTH = 32
STACK_TIMEOUT_MS = 5000.0  # the shed check holds requests queued
STACK_FLIGHT = 16  # (d) concurrent identical requests
STACK_SHED_BATCH = 40  # (e) batch requests against the 32-deep queue
STACK_SHED_INTERACTIVE = 8
STACK_QOS_BATCH_CLIENTS = 6  # (e) the reading round: closed-loop clients
STACK_QOS_BATCH_ROWS = 16
STACK_QOS_INTERACTIVE_CLIENTS = 2
STACK_QOS_REQUESTS = 40
STACK_CANARY_PCT = 25.0
STACK_CANARY_ROWS = 64
STACK_SWAP_CLIENTS = 8
STACK_SWAP_PER_CLIENT = 30
# pool: two replicas of the full-width CNN on cuda:0, each on its own
# stream; closed-loop JSON clients of 1..12 rows (f32 and int8 in turn).
POOL_REPLICAS = 2
# sharded phase: JAX's sharded kinds (tests/test_sharded.py KINDS) and its
# mixed example, each a pool on cuda:0 repeated k times.  Seed 12's smallest
# top-1 margins over the 128-row parity slice are ~0.1 (CNN), ~7.6e-3 (ViT)
# and ~0.15 (MoE ViT), its smallest gate-probability margin ~8.5e-5: far
# past the 1e-5 gates and the ~1e-7 sums they allow (CPU scan).
SHARDED_SPECS = ("tp4", "vtp4", "ep2", "pp2", "tp4,dp")
SHARDED_REQUESTS = 24  # sizes 1..12, twice
SHARDED_TIMED_RUNS = 30
POOL_CLIENTS = 8
POOL_PER_CLIENT = 12  # (b) per policy
POOL_SUPERVISOR_PER_CLIENT = 8  # (d)
POOL_KILLED_LAUNCHES = 4  # (d) three trip r1's circuit, one fails its first trial
POOL_TIMEOUT_MS = 5000.0
POOL_HEDGE_DELAY_MS = 20.0  # (e)
POOL_HANG_S = 2.0  # (e) r0's read-back hangs this long unless woken
# (f) two replicas x the 128-row top bucket; one row more than the pool's
# capacity is refused (the JAX router's cap), so 300 rows are
POOL_OVERSIZE_ROWS = 256
POOL_REFUSED_ROWS = 300
POOL_CACHE = 64  # (g) --response-cache
POOL_SWAP_PER_CLIENT = 20  # (g)
POOL_READ_PER_CLIENT = 20  # the latency readings, with 1 and 2 replicas
POOL_BUCKETED_LADDER = (1, 2, 4, 8, 128)  # (a): one client's 1..8 rows, and 128
POOL_BUCKETED_ROWS = 624  # (b) bucketed: 8 clients x 78 rows, each request rows of its own
DOT_TOL = 5e-4  # --int8-impl dot vs pallas log-probs (the conv ulp)
# compile: the processes of each group start together; each process's own
# timeout
COMPILE_PROC_TIMEOUT_S = 600
# fleet phase: two backends and one, warm off the compile phase's store
FLEET_BACKENDS = 2
# --fleet-heartbeat-timeout-s: under it, (c)'s stopped backend is found by
# its heartbeat before its third missed /readyz probe (a probe a second:
# 0.5 s apart, 0.5 s to time out)
FLEET_HEARTBEAT_S = 1.5
FLEET_READY_S = 180.0  # bring-up, and a replacement's
FLEET_REQUESTS = 16  # (a): seeded requests, one at a time
FLEET_KILL_AFTER = 40  # (b): answers before the kill, and again after
# loadgen phase: the port's load generator and SLO gate on the fleet's store
LOADGEN_CLIENTS = 8  # (b) the closed loop that sets the offered rate
LOADGEN_CLOSED_S = 3.0
LOADGEN_CLOSED_PLAN = 600  # its pre-encoded bodies, cycled
LOADGEN_OVERLOAD = 1.2  # (b) the ab-tail's offered rate over the closed loop's
LOADGEN_TAIL_S = 4.0  # (b) each rung's trace
LOADGEN_MIX = "interactive=0.8,batch=0.2"
LOADGEN_FLEET_RATE = 100.0  # (c) offered requests/s at 1 and 2 backends
LOADGEN_FLEET_REQUESTS = 400
LOADGEN_PROC_TIMEOUT_S = 400


_CLOCK = {"last": time.perf_counter()}


def emit(obj: dict) -> None:
    """One JSON line; a phase line carries its ``seconds``: the phase's
    own where it times itself, else the time since the last phase line."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "seconds": obj.get("seconds", now - _CLOCK["last"])}
        _CLOCK["last"] = now
    print(json.dumps(obj), flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def median_ms(torch, fn, runs: int = 60, warm: int = 5) -> float:
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events
    recorded between calls.  A sleep kernel ahead of them keeps the device
    busy while the host enqueues, so the gaps measure device time, not
    launch overhead."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(100_000_000)
    events[0].record()
    for i in range(runs):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(runs))


def head_bound(n: int, k: int, h: int, o: int) -> tuple[float, str]:
    """Least time (ms) for the fused head at n rows: each input read once,
    the output written once, against the int8 operations it must do."""
    nbytes = n * k * 4 + h * k + 2 * h * 4 + o * h + 2 * o * 4 + n * o * 4
    ops = 2 * n * (k * h + h * o)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def back_to_back_ms(torch, fn, calls: int = BACK_TO_BACK_CALLS, reps: int = 5,
                    warm: int = 5) -> float:
    """Device time per call of ``fn`` run ``calls`` times between one pair
    of CUDA events (behind a sleep kernel, so the host's enqueue stays
    ahead), divided by ``calls``; the median of ``reps`` such runs.  Unlike
    :func:`median_ms` no event sits between two calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def head_layers(torch, np, k: int, h: int, o: int, seed: int) -> tuple[dict, dict]:
    """Random int8 layers of the given widths on the card (quantize_params'
    layout: weight_q [out, in], scale and bias [out])."""
    rng = np.random.RandomState(seed)
    layers = []
    for out_w, in_w in ((h, k), (o, h)):
        layers.append({
            "weight_q": torch.from_numpy(rng.randint(-127, 128, (out_w, in_w)).astype(np.int8)),
            "scale": torch.from_numpy((rng.rand(out_w) * 1e-2).astype(np.float32)),
            "bias": torch.from_numpy(rng.randn(out_w).astype(np.float32)),
        })
    return tuple({key: v.cuda() for key, v in layer.items()} for layer in layers)


def head_edge_features(np, case: str):
    """tests/test_torch_quant.py's edge cases, built in the JAX package's
    NHWC column order and taken to the port's NCHW order."""
    from pytorch_mnist_ddp_tpu_torch.utils.convert import nchw_to_nhwc_feature_perm

    x = np.abs(np.random.RandomState(7).randn(4, 9216)).astype(np.float32)
    if case == "zero_row":
        x[1] = 0.0
    else:
        sign = -1.0 if case == "negative_ties" else 1.0
        x[:, 0] = 127.0
        x[:, 1:] = sign * (np.arange(9215) % 100 + 0.5).astype(np.float32)
    return np.ascontiguousarray(x[:, nchw_to_nhwc_feature_perm()])


def head_kernel_phase(torch, np, fc1: dict, fc2: dict, feats) -> dict[str, float]:
    """int8_head against its plain version with torch.equal at every case;
    returns the largest |kernel - plain| per case (0.0 when equal)."""
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih

    cases = [(f"n={n}", fc1, fc2, feats[:n]) for n in KERNEL_ROWS]
    cases += [(case, fc1, fc2, torch.from_numpy(head_edge_features(np, case)).cuda())
              for case in HEAD_EDGE_CASES]
    k, h, o = HEAD_RAGGED
    r1, r2 = head_layers(torch, np, k, h, o, seed=k)
    x_ragged = torch.from_numpy(
        np.random.RandomState(k + 1).randn(max(HEAD_RAGGED_ROWS), k).astype(np.float32)).cuda()
    cases += [(f"k={k} n={n}", r1, r2, x_ragged[:n]) for n in HEAD_RAGGED_ROWS]
    for k, h in HEAD_SHAPES:
        l1, l2 = head_layers(torch, np, k, h, o, seed=k + h)
        rng = np.random.RandomState(k + h + 1)
        x = torch.from_numpy(rng.randn(max(HEAD_SHAPES_ROWS), k).astype(np.float32)).cuda()
        cases += [(f"k={k} h={h} n={n}", l1, l2, x[:n]) for n in HEAD_SHAPES_ROWS]
    # x one float into its allocation: the kernel's element-wise x path
    offset = torch.empty(feats[:5].numel() + 1, device="cuda")
    offset[1:].copy_(feats[:5].reshape(-1))
    cases.append(("x one float off, n=5", fc1, fc2, offset[1:].view(5, -1)))
    errs, plans = {}, {}
    for name, l1, l2, x in cases:
        got = ih.fused_int8_head(l1, l2, x)
        want = ih.int8_head_reference(l1, l2, x)
        torch.cuda.synchronize()
        n_rows, k_in = x.shape
        plan = ih.launch_plan(n_rows, k_in, l1["weight_q"].shape[0], l2["weight_q"].shape[0], 0)
        plans[name] = {"cluster": plan["cluster"], "grid": list(plan["grid"]),
                       "passes": plan["passes"], "h_tiles": plan["h_tiles"],
                       "hid_smem": plan["hid_smem"]}
        errs[name] = float((got - want).abs().max())
        check(got.shape == want.shape, f"int8_head shape {tuple(got.shape)} at {name}")
        check(bool(torch.isfinite(got).all()), f"int8_head non-finite at {name}")
        check(torch.equal(got, want), f"int8_head off its plain version by {errs[name]} at {name}")
    emit({"phase": "kernel", "name": "int8_head", "check": "torch.equal",
          "max_abs_err_by_case": errs, "plan_by_case": plans})
    return errs


def head_times(torch, fc1: dict, fc2: dict, feats) -> tuple[dict, dict]:
    """int8_head per call and back to back at TIMED_ROWS, its plain version,
    torch._int_mm on fc1's product in both weight layouts, and the launch
    floor; returns the per-n readings and the floor."""
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih

    h, k = fc1["weight_q"].shape
    o = fc2["weight_q"].shape[0]
    layouts = {"row_major_copy": fc1["weight_q"].t().contiguous(),
               "column_major_view": fc1["weight_q"].t()}
    by_n = {}
    for n in TIMED_ROWS:
        f = feats[:n]
        kernel = lambda: ih.fused_int8_head(fc1, fc2, f)  # noqa: E731
        reading = {"ms": median_ms(torch, kernel),
                   "back_to_back_ms": back_to_back_ms(torch, kernel),
                   "plain_ms": median_ms(torch, lambda: ih.int8_head_reference(fc1, fc2, f))}
        # torch._int_mm takes more than 16 rows only: fewer are zero-padded.
        a_max = f.abs().amax(dim=-1, keepdim=True)
        xq = torch.zeros((max(n, INT_MM_MIN_ROWS), k), dtype=torch.int8, device=f.device)
        xq[:n] = torch.clamp(torch.round(f / (a_max / 127.0)), -127, 127).to(torch.int8)
        library = {}
        for name, w in layouts.items():
            try:
                library[name] = {"ms": median_ms(torch, lambda: torch._int_mm(xq, w)),
                                 "back_to_back_ms": back_to_back_ms(
                                     torch, lambda: torch._int_mm(xq, w))}
            except RuntimeError as e:  # a layout the library refuses is recorded
                library[name] = {"error": str(e).splitlines()[0]}
        timed = {name: v["ms"] for name, v in library.items() if "ms" in v}
        check(bool(timed), f"torch._int_mm refused both layouts at n={n}: {library}")
        best = min(timed, key=timed.get)
        reading["library_ms"] = timed[best]
        reading["library_layout"] = best
        reading["library_by_layout"] = library
        reading["library_rows"] = xq.shape[0]
        reading["bound_ms"], reading["bound_by"] = head_bound(n, k, h, o)
        plan = ih.launch_plan(n, k, h, o, 0)
        reading["cluster"], reading["grid"] = plan["cluster"], list(plan["grid"])
        by_n[str(n)] = reading
    one = torch.zeros(1, device="cuda")
    floor = {"ms": median_ms(torch, lambda: one.add_(1.0)),
             "back_to_back_ms": back_to_back_ms(torch, lambda: one.add_(1.0))}
    emit({"phase": "times", "name": "int8_head", "by_n": by_n, "launch_floor": floor,
          "library": "torch._int_mm on the fc1 product alone (no single PyTorch call "
                     f"computes the whole head), rows zero-padded to {INT_MM_MIN_ROWS}; "
                     "library_ms is the faster weight layout",
          "back_to_back": f"{BACK_TO_BACK_CALLS} calls between one pair of events, "
                          "divided by the count; median of 5"})
    return by_n, floor


def head_shape_times(torch, np) -> dict:
    """int8_head per call at HEAD_SHAPES, n = 8, beside its plain version
    and its bound."""
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih

    n, o = 8, HEAD_RAGGED[2]
    by_shape = {}
    for k, h in HEAD_SHAPES:
        l1, l2 = head_layers(torch, np, k, h, o, seed=k + h)
        x = torch.from_numpy(np.random.RandomState(k).randn(n, k).astype(np.float32)).cuda()
        plan = ih.launch_plan(n, k, h, o, 0)
        bound_ms, bound_by = head_bound(n, k, h, o)
        by_shape[f"k={k} h={h}"] = {
            "ms": median_ms(torch, lambda: ih.fused_int8_head(l1, l2, x)),
            "plain_ms": median_ms(torch, lambda: ih.int8_head_reference(l1, l2, x)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            **{key: plan[key] for key in ("cluster", "passes", "h_tiles", "hid_smem")}}
    emit({"phase": "times", "name": "int8_head", "rows": n, "by_shape": by_shape})
    return by_shape


def cold_ms(torch, fn, restore, runs: int = 30, warm: int = 3) -> float:
    """Median device time of ``fn`` with its inputs restored and the L2
    cache flushed (a write of L2_FLUSH_BYTES) before each call, by CUDA
    events around the call alone."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        restore()
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(runs)]
    torch.cuda._sleep(100_000_000)
    for start, end in pairs:
        restore()
        flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def adadelta_bound(name: str, n: int) -> tuple[float, str]:
    """Least time (ms) for one adadelta call over n elements."""
    nbytes, flops = ADADELTA_WORK[name]
    t_bytes, t_ops = n * nbytes / HBM_BYTES_PER_S, n * flops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def post_json(url: str, body: dict | bytes) -> dict:
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        check(r.status == 200, f"{url} answered {r.status}")
        return json.loads(r.read())


def get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as r:
        check(r.status == 200, f"{url} answered {r.status}")
        return r.read()


def adadelta_inputs(torch, np, n: int, seed: int, offset: int = 0):
    """p, g signed, sq and ac non-negative, on the card; ``offset`` starts
    every buffer that many elements into its allocation."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(n), rng.randn(n), np.abs(rng.randn(n)), np.abs(rng.randn(n))]
    out = []
    for a in arrays:
        buf = torch.empty(n + offset, dtype=torch.float32, device="cuda")
        buf[offset:].copy_(torch.from_numpy(a.astype(np.float32)))
        out.append(buf[offset:])
    return out


def adadelta_kernel_phase(torch, np) -> dict[str, float]:
    """Both modes against the plain version at every length; returns the
    worst error per kernel name."""
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af

    worst = {"adadelta_delta": 0.0, "adadelta_fused": 0.0}
    by_n = {}
    cases = [(n, 0) for n in ADADELTA_N] + [(33000, 1)]
    for n, offset in cases:
        p, g, sq, ac = adadelta_inputs(torch, np, n, n, offset)
        errs = {}
        for name in worst:
            kp, kg, ksq, kac = (t.clone() for t in (p, g, sq, ac))
            rp, rg, rsq, rac = (t.clone() for t in (p, g, sq, ac))
            if name == "adadelta_fused":
                af.fused_adadelta_flat(kp, kg, ksq, kac, 0.7)
                af.adadelta_flat_reference(rg, rsq, rac, 0.9, 1e-6, rp, 0.7)
                pairs = ((kp, rp), (ksq, rsq), (kac, rac))
            else:
                af.adadelta_delta_flat(kg, ksq, kac)
                af.adadelta_flat_reference(rg, rsq, rac, 0.9, 1e-6)
                pairs = ((kg, rg), (ksq, rsq), (kac, rac))
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in pairs)
            check(all(bool(torch.isfinite(a).all()) for a, _ in pairs),
                  f"{name} non-finite at n={n}")
            check(err <= ADADELTA_TOL, f"{name} off its plain version by {err} at n={n}")
            errs[name] = err
            worst[name] = max(worst[name], err)
        by_n[f"{n}" + (f"+{offset}" if offset else "")] = errs
    emit({"phase": "kernel", "name": "adadelta", "tolerance": ADADELTA_TOL,
          "max_abs_err_by_n": by_n})
    return worst


def train_step_phase(torch, np) -> dict[str, int]:
    """TRAIN_STEPS steps three ways from one set of weights; returns the
    adadelta launches of the phase."""
    from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
    from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.ops.adadelta import adadelta_init
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import (
        TrainState,
        make_train_state,
        make_train_step,
    )

    batch = 64
    images, labels = synthetic_mnist("train", TRAIN_STEPS * batch)
    xs = torch.from_numpy(normalize(images)).cuda().reshape(TRAIN_STEPS, batch, 28, 28, 1)
    ys = torch.from_numpy(labels.astype(np.int64)).cuda().reshape(TRAIN_STEPS, batch)
    w = torch.ones(batch, device="cuda")
    init = Net(torch.Generator().manual_seed(SEED)).state_dict()
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    try:
        # The delta kernel's steps twice more with cuDNN free to pick a
        # non-deterministic algorithm: whether they repeat bit for bit.
        for run in ("plain", "fused", "delta", "delta_free", "delta_free_again"):
            torch.backends.cudnn.deterministic = not run.startswith("delta_free")
            net = Net().cuda()
            net.load_state_dict(init)
            if run.startswith("delta"):
                state = make_train_state(net, use_pallas=True)
            else:
                state = TrainState(opt=adadelta_init(dict(net.named_parameters())))
            step = make_train_step(dropout=False, use_pallas=run != "plain")
            before = dict(af.LAUNCHES)
            t0 = time.perf_counter()
            losses = torch.stack([step(net, state, xs[i], ys[i], w, 1.0)
                                  for i in range(TRAIN_STEPS)])
            torch.cuda.synchronize()
            runs[run] = {
                "seconds": time.perf_counter() - t0,
                "losses": losses.cpu().numpy(),
                "params": {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()},
                "launches": {k: af.LAUNCHES[k] - before[k] for k in before},
            }
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain = runs["plain"]
    check(np.isfinite(plain["losses"]).all(), "plain train_step losses non-finite")
    check(plain["losses"][-1] < plain["losses"][0], "plain train_step did not learn")
    check(plain["launches"] == {"adadelta_delta": 0, "adadelta_fused": 0},
          f"plain update launched a kernel: {plain['launches']}")
    delta = {"adadelta_delta": TRAIN_STEPS, "adadelta_fused": 0}
    want = {"fused": {"adadelta_delta": 0, "adadelta_fused": TRAIN_STEPS}, "delta": delta,
            "delta_free": delta, "delta_free_again": delta}
    for run, w in want.items():
        check(runs[run]["launches"] == w, f"{run} launches {runs[run]['launches']} != {w}")
    free, again = runs["delta_free"]["params"], runs["delta_free_again"]["params"]
    free_repeats = all(np.array_equal(free[k], again[k]) for k in free)
    report = {}
    for run in ("fused", "delta"):
        r = runs[run]
        loss_diff = float(np.abs(r["losses"] - plain["losses"]).max())
        param_diff = max(float(np.abs(r["params"][k] - plain["params"][k]).max())
                         for k in plain["params"])
        for k in plain["params"]:
            check(np.allclose(r["params"][k], plain["params"][k], rtol=TRAIN_STEP_RTOL, atol=0),
                  f"{run} train_step {k} off the plain run")
        check(np.allclose(r["losses"], plain["losses"], rtol=TRAIN_STEP_RTOL, atol=0),
              f"{run} train_step losses off the plain run")
        report[run] = {"max_abs_loss_diff": loss_diff, "max_abs_param_diff": param_diff,
                       "launches": r["launches"], "seconds": r["seconds"]}
    emit({"phase": "train_step", "steps": TRAIN_STEPS, "rtol": TRAIN_STEP_RTOL,
          "plain_first_last_loss": [float(plain["losses"][0]), float(plain["losses"][-1])],
          "plain_seconds": plain["seconds"], "vs_plain": report,
          "delta_without_deterministic_cudnn_repeats_bit_for_bit": free_repeats})
    return {k: sum(r["launches"][k] for r in runs.values()) for k in plain["launches"]}


TRAIN_LINE = re.compile(r"^Train Epoch: (\d+) \[(\d+)/(\d+) \((\d+)%\)\]\tLoss: (\d+\.\d{6})$")
TEST_LINE = re.compile(r"^Test set: Average loss: (\d+\.\d{4}), Accuracy: (\d+)/(\d+) \((\d+)%\)$")


def fit_run(flags: list[str], save_path: str | None = None, registry=None) -> dict:
    """The trainer's fit() on the card with mnist.py's ``flags``: the
    model, its state, the printed lines, fit's timings, the wall seconds
    and the adadelta launches of the run (``registry`` takes the
    loaders' prefetch histograms)."""
    from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.trainer import fit

    args = build_parser().parse_args(flags)
    timings: dict = {}
    before = dict(af.LAUNCHES)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        model, state = fit(args, "cuda", save_path=save_path, timings=timings,
                           registry=registry)
    return {"args": args, "model": model, "state": state, "timings": timings,
            "lines": [ln for ln in out.getvalue().splitlines() if ln],
            "wall": time.perf_counter() - t0,
            "launches": {k: af.LAUNCHES[k] - before[k] for k in before}}


def train_phase(torch) -> tuple[dict[str, int], dict]:
    """fit() on the card, --pallas-opt for two epochs then plain for one;
    returns the adadelta launches of the phase and the --pallas-opt run
    (the fused phase holds --fused to it)."""
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af

    launches = {k: 0 for k in af.LAUNCHES}
    legs = {}
    for leg, flags in (("pallas_opt", ["--epochs", "2", "--pallas-opt"]),
                       ("plain", ["--epochs", "1"])):
        run = fit_run(flags)
        args, model, state, timings = run["args"], run["model"], run["state"], run["timings"]
        wall, got, lines = run["wall"], run["launches"], run["lines"]
        for k in launches:
            launches[k] += got[k]
        train = [TRAIN_LINE.match(ln) for ln in lines if ln.startswith("Train Epoch")]
        tests = [TEST_LINE.match(ln) for ln in lines if ln.startswith("Test set")]
        check(all(train) and all(tests), f"{leg}: malformed lines")
        other = [ln for ln in lines if not ln.startswith(("Train Epoch", "Test set", "MNIST IDX"))]
        check(not other, f"{leg}: unexpected output {other[:3]}")
        losses = [float(m.group(5)) for m in train]
        steps = sum(timings["epoch_steps"])
        check(len(tests) == args.epochs, f"{leg}: {len(tests)} test summaries")
        check(all(math.isfinite(x) for x in losses), f"{leg}: non-finite loss")
        check(next(model.parameters()).device.type == "cuda", f"{leg}: model not on the card")
        check(state.step == steps, f"{leg}: {state.step} optimizer steps, loader gave {steps}")
        want = {"adadelta_delta": steps if args.pallas_opt else 0, "adadelta_fused": 0}
        check(got == want, f"{leg}: launches {got} != {want}")
        if leg == "pallas_opt":
            check(losses[-1] < losses[0], f"{leg}: last logged loss {losses[-1]} not below "
                  f"the first {losses[0]}")
            acc1 = timings["epoch1_test_accuracy"]
            check(acc1 >= EPOCH1_MIN_ACCURACY, f"epoch-1 test accuracy {acc1} < "
                  f"{EPOCH1_MIN_ACCURACY}")
        secs = timings["epoch_train_s"]
        legs[leg] = {
            "dataset": timings["dataset"], "train_size": timings["train_size"],
            "epochs": args.epochs, "steps_per_epoch": timings["epoch_steps"],
            "train_seconds_per_epoch": secs,
            "images_per_s": [n * args.batch_size / t
                             for n, t in zip(timings["epoch_steps"], secs)],
            "test_accuracy_by_epoch": [int(m.group(2)) / int(m.group(3)) for m in tests],
            "test_loss_by_epoch": [float(m.group(1)) for m in tests],
            "first_last_logged_loss": [losses[0], losses[-1]],
            "wall_seconds": wall, "launches": got,
        }
        if leg == "pallas_opt":
            kept = run
    emit({"phase": "train", "legs": legs})
    return launches, kept


def same_run(torch, a: dict, b: dict) -> dict[str, bool]:
    """torch.equal of two fit() runs' parameters, each accumulator and step."""
    pa, pb = dict(a["model"].named_parameters()), dict(b["model"].named_parameters())
    sa, sb = a["state"], b["state"]
    return {"params": list(pa) == list(pb) and all(torch.equal(pa[k], pb[k]) for k in pa),
            "square_avg": torch.equal(sa.opt.square_avg, sb.opt.square_avg),
            "acc_delta": torch.equal(sa.opt.acc_delta, sb.opt.acc_delta),
            "step": sa.step == sb.step}


def resume_phase(torch, workdir: str, full: dict) -> tuple[dict[str, int], list[float]]:
    """--save-state / --resume-state / --resume through fit() on the card,
    CNN at the CLI defaults with --pallas-opt on the synthetic 60k set:
    (a) two epochs (``full``: the train phase's run, whose launches that
    phase counts); (b) one epoch with --save-state, then --resume-state
    for one, equal to (a) bit for bit; (c) a per-leaf archive resumed with
    --pallas-opt (the delta kernel on the restored accumulators) and that
    run's flat archive resumed without; (d) --resume from a --save-model
    file at --epochs 0.  Returns the adadelta launches of the phase and
    (a)'s seconds per epoch."""
    import os

    from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import load_inference_state

    path = os.path.join(workdir, "state.npz")
    first = fit_run(["--epochs", "1", "--pallas-opt", "--save-state", path])
    archive_bytes = os.path.getsize(path)
    resumed = fit_run(["--epochs", "1", "--pallas-opt", "--resume-state", path])
    equal = same_run(torch, full, resumed)
    epoch2 = [ln for ln in full["lines"] if ln.startswith(("Train Epoch: 2 ", "Test set"))][1:]
    report = {
        "equal_to_uninterrupted": equal,
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "archive_bytes": archive_bytes,
        "seconds_per_epoch": {"uninterrupted": full["timings"]["epoch_train_s"],
                              "first": first["timings"]["epoch_train_s"],
                              "resumed": resumed["timings"]["epoch_train_s"]},
        "wall_seconds": {"uninterrupted": full["wall"], "first": first["wall"],
                         "resumed": resumed["wall"]},
        "steps": {"uninterrupted": full["state"].step, "resumed": resumed["state"].step},
    }
    # (c) and (d), cut to RESUME_LIMIT samples
    limit = ["--epochs", "1", "--train-limit", str(RESUME_LIMIT)]
    leaf, flat, model_pt = (os.path.join(workdir, n) for n in ("leaf.npz", "flat.npz", "m.pt"))
    saved = fit_run(limit + ["--save-state", leaf, "--save-model"], save_path=model_pt)
    to_flat = fit_run(limit + ["--pallas-opt", "--resume-state", leaf, "--save-state", flat])
    to_leaf = fit_run(limit + ["--resume-state", flat])
    loaded = fit_run(["--epochs", "0", "--resume", model_pt])
    want = load_inference_state(model_pt)
    got = {k: v.cpu() for k, v in loaded["model"].state_dict().items()}
    resumed_steps = sum(to_flat["timings"]["epoch_steps"])
    report["layouts"] = {
        "per_leaf_archive_bytes": os.path.getsize(leaf),
        "per_leaf_to_pallas_opt": {"steps": resumed_steps, "launches": to_flat["launches"]},
        "flat_to_plain": {"steps": sum(to_leaf["timings"]["epoch_steps"]),
                          "launches": to_leaf["launches"]},
    }
    report["resume_model_equal"] = sorted(got) == sorted(want) and all(
        torch.equal(got[k], want[k]) for k in want)
    emit({"phase": "resume", **report})

    check(all(equal.values()), f"--resume-state run off the uninterrupted one: {equal}")
    check(any(ln.startswith("Train Epoch: 2 ") for ln in resumed["lines"])
          and not any(ln.startswith("Train Epoch: 1 ") for ln in resumed["lines"]),
          "the resumed run does not log epoch 2")
    check([ln for ln in resumed["lines"] if not ln.startswith("MNIST IDX")] == epoch2,
          "the resumed run's lines are not the uninterrupted run's epoch 2")
    check(to_flat["launches"] == {"adadelta_delta": resumed_steps, "adadelta_fused": 0},
          f"per-leaf archive under --pallas-opt: launches {to_flat['launches']} for "
          f"{resumed_steps} resumed steps")
    check(to_flat["state"].step == saved["state"].step + resumed_steps,
          "the per-leaf archive's step counter did not continue")
    check(to_leaf["launches"] == {"adadelta_delta": 0, "adadelta_fused": 0},
          f"flat archive without --pallas-opt launched {to_leaf['launches']}")
    for run in (to_flat, to_leaf):
        check(all(bool(torch.isfinite(p).all()) for p in run["model"].parameters()),
              "a resumed layout leg's parameters are non-finite")
    check(report["resume_model_equal"], "--resume at --epochs 0 off the file's parameters")
    check(loaded["state"].step == 0 and loaded["launches"]["adadelta_delta"] == 0,
          "--resume at --epochs 0 took steps")
    launches = {}
    for run in (first, resumed, saved, to_flat, to_leaf, loaded):
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    steps = first["state"].step + resumed_steps + (resumed["state"].step - first["state"].step)
    check(launches == {"adadelta_delta": steps, "adadelta_fused": 0},
          f"resume phase launches {launches}, --pallas-opt steps {steps}")
    return launches, full["timings"]["epoch_train_s"]


def cnn_variants_phase(torch, np, f32_epoch_s: list[float]) -> dict[str, int]:
    """--conv-impl and --bf16 on the card: TRAIN_STEPS steps of each
    conv_impl from one set of weights on fixed batches (dropout off,
    deterministic cuDNN, the delta kernel), the im2col ones held to cuDNN's
    conv; then two epochs of --bf16 --pallas-opt through fit() with the
    f32 accuracy floor after the first (the first epoch is the process's
    first bf16 convolution work), beside resume's two f32 --pallas-opt
    epochs.  Returns the adadelta launches of the phase."""
    from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
    from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
    from pytorch_mnist_ddp_tpu_torch.models.net import CONV_IMPLS, Net
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state, make_train_step

    batch = 64
    images, labels = synthetic_mnist("train", TRAIN_STEPS * batch)
    xs = torch.from_numpy(normalize(images)).cuda().reshape(TRAIN_STEPS, batch, 28, 28, 1)
    ys = torch.from_numpy(labels.astype(np.int64)).cuda().reshape(TRAIN_STEPS, batch)
    w = torch.ones(batch, device="cuda")
    init = Net(torch.Generator().manual_seed(SEED)).state_dict()
    runs = {}
    launches = {k: 0 for k in af.LAUNCHES}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for impl in CONV_IMPLS:
            net = Net().cuda()
            net.load_state_dict(init)
            state = make_train_state(net, use_pallas=True)
            step = make_train_step(dropout=False, use_pallas=True, conv_impl=impl)
            before = dict(af.LAUNCHES)
            t0 = time.perf_counter()
            losses = torch.stack([step(net, state, xs[i], ys[i], w, 1.0)
                                  for i in range(TRAIN_STEPS)])
            torch.cuda.synchronize()
            got = {k: af.LAUNCHES[k] - before[k] for k in before}
            check(got == {"adadelta_delta": TRAIN_STEPS, "adadelta_fused": 0},
                  f"conv_impl {impl} launches {got}")
            for k in launches:
                launches[k] += got[k]
            runs[impl] = {"seconds": time.perf_counter() - t0, "losses": losses.cpu().numpy(),
                          "params": {k: v.detach().cpu().numpy()
                                     for k, v in net.state_dict().items()}}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    conv = runs["conv"]
    check(np.isfinite(conv["losses"]).all() and conv["losses"][-1] < conv["losses"][0],
          "conv steps did not learn")
    report = {}
    for impl in CONV_IMPLS[1:]:
        r = runs[impl]
        ok_loss = np.allclose(r["losses"], conv["losses"], rtol=VARIANT_LOSS_RTOL,
                              atol=VARIANT_LOSS_ATOL)
        ok_params = all(np.allclose(r["params"][k], conv["params"][k], rtol=0,
                                    atol=VARIANT_PARAM_ATOL) for k in conv["params"])
        report[impl] = {
            "max_abs_loss_diff": float(np.abs(r["losses"] - conv["losses"]).max()),
            "max_rel_loss_diff": float((np.abs(r["losses"] - conv["losses"])
                                        / np.abs(conv["losses"])).max()),
            "max_abs_param_diff": max(float(np.abs(r["params"][k] - conv["params"][k]).max())
                                      for k in conv["params"]),
            "seconds": r["seconds"], "within_gate": ok_loss and ok_params}
    bf16 = fit_run(["--epochs", "2", "--bf16", "--pallas-opt"])
    steps = sum(bf16["timings"]["epoch_steps"])
    acc1 = bf16["timings"]["epoch1_test_accuracy"]
    emit({"phase": "cnn_variants", "steps": TRAIN_STEPS,
          "gate": {"loss_rtol": VARIANT_LOSS_RTOL, "loss_atol": VARIANT_LOSS_ATOL,
                   "param_atol": VARIANT_PARAM_ATOL},
          "conv_seconds": conv["seconds"], "vs_conv": report,
          "bf16": {"epoch1_test_accuracy": acc1,
                   "seconds_per_epoch": bf16["timings"]["epoch_train_s"],
                   "f32_seconds_per_epoch": f32_epoch_s,
                   "launches": bf16["launches"], "steps": steps}})
    for impl, r in report.items():
        check(r["within_gate"], f"conv_impl {impl} off cuDNN's conv: {r}")
    check(bf16["launches"] == {"adadelta_delta": steps, "adadelta_fused": 0},
          f"--bf16 --pallas-opt launches {bf16['launches']} for {steps} steps")
    check(acc1 >= EPOCH1_MIN_ACCURACY, f"--bf16 epoch-1 test accuracy {acc1} < "
          f"{EPOCH1_MIN_ACCURACY}")
    for k in launches:
        launches[k] += bf16["launches"][k]
    return launches


def adadelta_times(torch, np) -> dict[str, dict]:
    """Both modes, their plain version and torch.optim.Adadelta at the
    model's N: cold (L2 flushed before each call) and warm (back to
    back)."""
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af

    n = ADADELTA_N[-1]
    lr = 0.7
    src = adadelta_inputs(torch, np, n, 5)
    work = [t.clone() for t in src]

    def restore():
        for dst, s in zip(work, src):
            dst.copy_(s)

    p, g, sq, ac = work
    calls = {
        "adadelta_delta": (lambda: af.adadelta_delta_flat(g, sq, ac),
                           lambda: af.adadelta_flat_reference(g, sq, ac, 0.9, 1e-6)),
        "adadelta_fused": (lambda: af.fused_adadelta_flat(p, g, sq, ac, lr),
                           lambda: af.adadelta_flat_reference(g, sq, ac, 0.9, 1e-6, p, lr)),
    }
    # The nearest PyTorch path: torch.optim.Adadelta over one flat
    # parameter (several foreach launches); a yardstick the port never calls.
    param = torch.nn.Parameter(p)
    param.grad = g
    opt = torch.optim.Adadelta([param], lr=lr, foreach=True)
    opt.step()
    opt_state = opt.state[param]

    def restore_library():
        restore()
        opt_state["square_avg"].copy_(src[2])
        opt_state["acc_delta"].copy_(src[3])

    library_ms = cold_ms(torch, opt.step, restore_library)
    out = {}
    for name, (kernel, plain) in calls.items():
        bound_ms, bound_by = adadelta_bound(name, n)
        out[name] = {
            "n": n, "ms": cold_ms(torch, kernel, restore),
            "plain_ms": cold_ms(torch, plain, restore),
            "warm_ms": median_ms(torch, kernel), "warm_plain_ms": median_ms(torch, plain),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        }
    emit({"phase": "times", "name": "adadelta", "by_kernel": out,
          "cold": "inputs restored and a 256 MiB buffer written before each call",
          "library": "torch.optim.Adadelta([flat], foreach=True).step() with "
                     "p -= lr * delta, as adadelta_fused computes"})
    return out


def profile_window(torch, window, step_once, find: str | None = None) -> dict:
    """Wall and device-busy time per step of ``step_once(x, y, w)`` over the
    batches of ``window`` under torch.profiler, with the top device ops;
    with ``find``, also the ops whose name holds it (``found``: calls and
    microseconds per call, on the device and on the host).  The steps'
    records alone are counted, and the wall time is theirs:
    ``prefix_records_lost`` says how many of the sleep kernels' records
    the profiler dropped, ``launches_without_a_device_record`` how many of
    the steps' launches lost theirs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PREFIX_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        for x, y, w in window:
            step_once(x, y, w)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    device_us, kernels, top, found, uneven, prefix = 0.0, 0, [], {}, {}, 0
    for evt in prof.key_averages():
        if evt.device_type.name == "CUDA" and SLEEP_KERNEL in evt.key:
            prefix += evt.count
            continue
        if find is not None and find in evt.key.lower():
            side = "device" if evt.device_type.name == "CUDA" else "host"
            us = getattr(evt, "device_time_total" if side == "device" else "cpu_time_total")
            found[f"{side} {evt.key[:80]}"] = {"calls": evt.count,
                                               "us_per_call": us / evt.count}
        if evt.device_type.name != "CUDA":
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        device_us += us
        kernels += evt.count
        top.append((us, evt.key[:60], evt.count))
        if evt.count % len(window):
            uneven[evt.key[:60]] = evt.count
    top.sort(reverse=True)
    # the steps' launches: those after the idle margin that follows the prefix
    events = prof.events()
    launches = sorted((e.time_range.start, e.id) for e in events
                      if e.device_type.name != "CUDA" and e.name.startswith(LAUNCH_EVENTS))
    first = next((i + 1 for i, (a, b) in enumerate(zip(launches, launches[1:]))
                  if b[0] - a[0] > PROFILE_MARGIN_S * 5e5), 0)
    recorded = {e.id for e in events if e.device_type.name == "CUDA"}
    lost = [i for i, (_, cid) in enumerate(launches[first:]) if cid not in recorded]
    steps = len(window)
    extra = {} if find is None else {"found": found}
    return {**extra,
        "prefix_records_lost": PROFILE_PREFIX_KERNELS - prefix,
        "launches_without_a_device_record": len(lost), "lost_launch_positions": lost[:8],
        "steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": device_us / 1e3 / steps if device_us else None,
        "device_idle_share": 1 - device_us / 1e6 / wall if device_us else None,
        "device_ops_per_step": kernels / steps,
        "uneven_device_ops": uneven,
        "top_device_ops": [{"name": k, "ms_per_step": us / 1e3 / steps, "count": c}
                           for us, k, c in top[:6]],
    }


def loader_batches(torch):
    """One epoch of the synthetic train set's batches of 64 on the card,
    and the seconds the loader took for it."""
    from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
    from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist

    images, labels = synthetic_mnist("train")
    loader = DataLoader(images, labels, 64, torch.device("cuda"), seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = list(loader.epoch(1))
    torch.cuda.synchronize()
    return batches, time.perf_counter() - t0


def train_profile_phase(torch, np) -> None:
    """Where a training step's time goes, for the plain update and the
    delta kernel: the loader alone over one epoch, then PROFILE_STEPS
    steps on fixed batches under torch.profiler (wall per step, device
    busy time per step, kernel launches per step, the top kernels), with
    deterministic cuDNN as the trainer sets it; the delta kernel's steps
    once more with cuDNN free to pick a non-deterministic algorithm, and
    under --bf16, with and without it; then whole epochs of the delta
    kernel's steps with and without it, in turns: what determinism
    costs."""
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state, make_train_step
    from pytorch_mnist_ddp_tpu_torch.utils.rng import split_streams

    batches, loader_s = loader_batches(torch)
    report = {"loader_seconds_per_epoch": loader_s, "loader_batches": len(batches)}
    deterministic = torch.backends.cudnn.deterministic
    try:
        for name, pallas, det, dtype in (
                ("plain", False, True, torch.float32), ("pallas_opt", True, True, torch.float32),
                ("pallas_opt_nondeterministic", True, False, torch.float32),
                ("pallas_opt_bf16", True, True, torch.bfloat16),
                ("pallas_opt_bf16_nondeterministic", True, False, torch.bfloat16)):
            torch.backends.cudnn.deterministic = det
            net = Net(torch.Generator().manual_seed(SEED)).cuda()
            state = make_train_state(net, use_pallas=pallas)
            step = make_train_step(use_pallas=pallas, dropout_seed=split_streams(1)["dropout"],
                                   compute_dtype=dtype)
            for x, y, w in batches[:10]:  # warm-up
                step(net, state, x, y, w, 1.0)
            torch.cuda.synchronize()
            report[name] = profile_window(torch, batches[10:10 + PROFILE_STEPS],
                                          lambda x, y, w: step(net, state, x, y, w, 1.0))
        # Seconds per epoch of the delta kernel's steps over the epoch's
        # batches with and without deterministic cuDNN, in turns (ABBA),
        # each from fresh weights: what determinism costs end to end.
        epoch_s: dict[bool, list[float]] = {True: [], False: []}
        for det in (True, False, False, True):
            torch.backends.cudnn.deterministic = det
            net = Net(torch.Generator().manual_seed(SEED)).cuda()
            state = make_train_state(net, use_pallas=True)
            step = make_train_step(use_pallas=True, dropout_seed=split_streams(1)["dropout"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x, y, w in batches[:ABBA_STEPS]:
                step(net, state, x, y, w, 1.0)
            torch.cuda.synchronize()
            epoch_s[det].append(time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    report[f"pallas_opt_seconds_per_{ABBA_STEPS}_steps"] = {"deterministic": epoch_s[True],
                                                         "nondeterministic": epoch_s[False]}
    emit({"phase": "train_profile", **report})


def load_tool(name: str):
    """The module ``tools/<name>.py`` of this checkout, by its path (the
    name ``tools`` may be taken by an installed package)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def waited_process(proc, t0: float, timeout: float = 600) -> tuple:
    """``proc``'s exit code, stdout, stderr and the wall seconds from
    ``t0`` to its exit.  A child still running after ``timeout`` seconds
    is killed and reaped, and the wait raises ``TimeoutExpired``."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return proc.returncode, out, err, time.perf_counter() - t0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no one listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_rank_program(argv: list[str]) -> int:
    """``chip_smoke.py --ddp-rank OUT <mnist_ddp flags>``: the rank program
    the launcher runs in the ddp phase's first leg.  It is mnist_ddp's
    main (``mnist_ddp.run`` between the parse and the wall-clock line,
    what ``-m pytorch_mnist_ddp_tpu_torch.mnist_ddp`` runs), and then it
    writes what only this process can see to OUT: its kernel launch
    counts, fit's timings and the backend its group was formed with."""
    import os

    import torch.distributed as dist

    from pytorch_mnist_ddp_tpu_torch import mnist_ddp
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.utils.logging import total_time_line

    out, flags = argv[0], argv[1:]
    backends = []
    init_process_group = dist.init_process_group

    def recording(backend, *args, **kwargs):
        backends.append(backend)
        return init_process_group(backend, *args, **kwargs)

    dist.init_process_group = recording
    start = time.time()
    timings: dict = {}
    _, state = mnist_ddp.run(mnist_ddp.build_parser().parse_args(flags), timings)
    print(total_time_line(time.time() - start))
    with open(f"{out}.rank{os.environ['RANK']}", "w") as f:
        json.dump({"launches": af.LAUNCHES, "timings": timings, "backends": backends,
                   "step": state.step}, f)
    return 0


def ddp_gloo_rank(rank: int, init_file: str, workdir: str) -> None:
    """Rank ``rank`` of 2 in the ddp phase's second leg: a gloo group whose
    two ranks share cuda:0 (NCCL refuses two ranks on one device; gloo
    all-reduces CUDA tensors through the host).  DDP_STEPS steps three
    ways on this rank's half of the fixed global batches, dropout off,
    then the DDP_ZERO_WAYS (--zero, --zero --syncbn and the plain --syncbn
    way the latter shards); writes each way's losses, parameters and
    kernel launches."""
    import os

    import numpy as np
    import torch

    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state, make_train_step
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import (
        destroy_distributed,
        init_distributed_mode,
    )

    # fit()'s switches, which this fresh process has not inherited: TF32
    # off and deterministic cuDNN, as in the one-rank run it is held to.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    with contextlib.redirect_stdout(io.StringIO()):
        world = init_distributed_mode(f"file://{init_file}", rdzv_timeout_s=60, backend="gloo")
    data = np.load(os.path.join(workdir, "batches.npz"))
    rows = slice(rank * DDP_RANK_BATCH, (rank + 1) * DDP_RANK_BATCH)
    xs, ys = (torch.from_numpy(data[k][:, rows]).cuda() for k in ("xs", "ys"))
    w = torch.ones(DDP_RANK_BATCH, device="cuda")
    out = {"backend": torch.distributed.get_backend(), "device": str(xs.device)}
    try:
        for way, pallas, syncbn in DDP_WAYS:
            net = Net(torch.Generator().manual_seed(SEED), use_bn=syncbn).cuda()
            state = make_train_state(net, use_pallas=pallas)
            step = make_train_step(dropout=False, use_pallas=pallas, world=world)
            before = dict(af.LAUNCHES)
            losses = []
            for i in range(DDP_STEPS):
                losses.append(step(net, state, xs[i], ys[i], w, 1.0))
                if i + 1 == DDP_GATE_STEPS:
                    gate = {k: v.to("cpu", copy=True) for k, v in net.state_dict().items()}
            out[way] = {"losses": torch.stack(losses).cpu(), "gate_state": gate,
                        "state": {k: v.cpu() for k, v in net.state_dict().items()},
                        "launches": {k: af.LAUNCHES[k] - before[k] for k in before}}
        for way, syncbn, zero in DDP_ZERO_WAYS:
            net = Net(torch.Generator().manual_seed(SEED), use_bn=syncbn).cuda()
            state = make_train_state(net, zero=zero, world=world)
            step = make_train_step(dropout=False, world=world)
            before = dict(af.LAUNCHES)
            losses = [step(net, state, xs[i], ys[i], w, 1.0) for i in range(DDP_STEPS)]
            out[way] = {"losses": torch.stack(losses).cpu(),
                        "state": {k: v.cpu() for k, v in net.state_dict().items()},
                        "launches": {k: af.LAUNCHES[k] - before[k] for k in before}}
        out["fused_refused"] = fused_on_gloo(world, os.path.join(workdir, "fused_idx"))
    finally:
        destroy_distributed()
    torch.save(out, os.path.join(workdir, f"gloo_rank{rank}.pt"))


def fused_on_gloo(world, root: str) -> str | None:
    """``mnist_ddp --fused`` on a gloo world of ranks sharing the card
    (the fused phase's check (d), in the ddp phase's gloo world): what the
    trainer raised (only NCCL's collectives can be captured), or None."""
    from pytorch_mnist_ddp_tpu_torch import trainer
    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser

    try:
        with contextlib.redirect_stdout(io.StringIO()):
            trainer._fit(build_parser().parse_args(["--data-root", root, "--epochs", "1",
                                                    "--fused"]), None, None, None, world)
    except ValueError as e:
        return str(e)
    return None


def ddp_two_halves(torch, xs, ys, pallas: bool) -> tuple:
    """The two gloo ranks' steps without BatchNorm computed in this
    process: each half of the global batch's gradients as its rank
    computes them, their sum halved, the same update.  Returns the
    halves' losses [steps, 2], the final state and the launches."""
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import forward_loss, make_train_state

    net = Net(torch.Generator().manual_seed(SEED)).cuda()
    state = make_train_state(net, use_pallas=pallas)
    params = dict(net.named_parameters())
    w = torch.ones(DDP_RANK_BATCH, device="cuda")
    two = torch.full((), 2.0, device="cuda")
    before = dict(af.LAUNCHES)
    losses = []
    for x, y in zip(xs, ys):
        net.train()
        flats = []
        for half in range(2):
            rows = slice(half * DDP_RANK_BATCH, (half + 1) * DDP_RANK_BATCH)
            loss = forward_loss(net, x[rows], y[rows], w, None)
            grads = torch.autograd.grad(loss, list(params.values()))
            flats.append(torch.cat([g.reshape(-1) for g in grads]))
            losses.append(loss.detach())
        flat = (flats[0] + flats[1]).div_(two)
        if af.is_flat_state(state.opt):
            af.adadelta_step_flat(params, flat, state.opt, 1.0)
        else:
            views = flat.split([p.numel() for p in params.values()])
            af.adadelta_update_best(params, {k: v.view_as(p) for (k, p), v in
                                             zip(params.items(), views)}, state.opt, 1.0)
    launches = {k: af.LAUNCHES[k] - before[k] for k in before}
    return (torch.stack(losses).view(-1, 2).cpu(),
            {k: v.cpu() for k, v in net.state_dict().items()}, launches)


def ddp_profile(torch, np) -> dict:
    """An NCCL world of one in this process: DDP_PROFILE_STEPS
    --pallas-opt steps at --batch-size 200 under torch.profiler, with the
    all-reduce's own time."""
    import os

    import torch.distributed as dist

    from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
    from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state, make_train_step
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import (
        destroy_distributed,
        init_distributed_mode,
    )
    from pytorch_mnist_ddp_tpu_torch.utils.rng import split_streams

    images, labels = synthetic_mnist("train")
    batches = list(DataLoader(images, labels, DDP_BATCH, torch.device("cuda"), seed=1).epoch(1))
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            world = init_distributed_mode()
        backend = dist.get_backend()
        net = Net(torch.Generator().manual_seed(SEED)).cuda()
        state = make_train_state(net, use_pallas=True)
        step = make_train_step(use_pallas=True, dropout_seed=split_streams(1)["dropout"],
                               world=world)
        for x, y, w in batches[:10]:  # warm-up, the communicator's set-up included
            step(net, state, x, y, w, 1.0)
        torch.cuda.synchronize()
        window = profile_window(torch, batches[10:10 + DDP_PROFILE_STEPS],
                                lambda x, y, w: step(net, state, x, y, w, 1.0), find="nccl")
    finally:
        destroy_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"backend": backend, "steps_taken": state.step, **window}


def ddp_phase(torch, np, workdir: str) -> tuple[dict[str, int], dict[str, int]]:
    """mnist_ddp on the card.  (1) An NCCL world of one through the
    launcher at --batch-size 200 --pallas-opt --save-model for one epoch
    of the synthetic 60k set: the banner, accuracy, row 3 once a step, and
    mnist_cnn.pt (module. keys) torch.equal to mnist.py's fit() with the
    same flags in this process; then, once every process of the phase has
    ended, a profiled window of the same step in an NCCL world of one here.
    (2) Two ranks sharing the card over gloo (their processes run beside
    (1)'s),
    DDP_STEPS fixed steps three ways (plain, --pallas-opt, --syncbn
    --pallas-opt): the ranks equal; within the CPU trajectory gates of a
    one-rank run at twice the batch over the same global batches, after
    all DDP_STEPS with --syncbn and after DDP_GATE_STEPS without; and,
    without BatchNorm, equal bit for bit to the same steps computed in this
    process (:func:`ddp_two_halves`), and after DDP_STEPS no farther from
    the f64 trajectory than DDP_F64_RATIO times the farthest of the
    one-rank run's own orders (``tools/ddp_f32_orders.py``).
    Returns the adadelta launches of the data-parallel step (the launcher
    rank, the profiled world, the gloo ranks) and, apart, those of the
    references it is held to (``fit()``, the one-rank runs, the
    one-process halves)."""
    import multiprocessing
    import os

    from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
    from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state, make_train_step
    from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import load_inference_state
    from pytorch_mnist_ddp_tpu_torch.utils.logging import distributed_init_banner

    t_phase = time.perf_counter()
    launches = {k: 0 for k in af.LAUNCHES}  # the data-parallel step's own
    references = {k: 0 for k in af.LAUNCHES}
    start = dict(af.LAUNCHES)

    # (1) the launcher, --nproc_per_node=1: an NCCL world of one; (2)'s two
    # gloo ranks start beside it, and fit()'s reference runs here meanwhile
    counts = os.path.join(workdir, "counts")
    flags = ["--batch-size", str(DDP_BATCH), "--epochs", "1", "--pallas-opt"]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         "--nproc_per_node=1", f"--master_port={free_port()}", os.path.abspath(__file__),
         "--ddp-rank", counts, *flags, "--save-model"],
        cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    images, labels = synthetic_mnist("train", DDP_STEPS * 2 * DDP_RANK_BATCH)
    xs = normalize(images).reshape(DDP_STEPS, 2 * DDP_RANK_BATCH, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(DDP_STEPS, 2 * DDP_RANK_BATCH)
    np.savez(os.path.join(workdir, "batches.npz"), xs=xs, ys=ys)
    vit_idx_root(np, workdir, name="fused_idx")  # the ranks' --fused refusal
    ctx = multiprocessing.get_context("spawn")
    init_file = os.path.join(workdir, "gloo_rdzv")
    t_gloo = time.perf_counter()
    procs = [ctx.Process(target=ddp_gloo_rank, args=(r, init_file, workdir)) for r in (0, 1)]
    for p in procs:
        p.start()
    with ThreadPoolExecutor(1) as pool:
        launcher_done = pool.submit(waited_process, proc, t0)
        alone = fit_run(flags)
        rc, stdout, stderr, launcher_s = launcher_done.result()
    for p in procs:
        p.join(timeout=300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(timeout=10)
    gloo_s = time.perf_counter() - t_gloo
    check(not alive and [p.exitcode for p in procs] == [0, 0],
          f"gloo ranks exited {[p.exitcode for p in procs]}")
    check(rc == 0, f"launcher leg exited {rc}: {stderr[-2000:]}")
    with open(counts + ".rank0") as f:
        rank0 = json.load(f)
    lines = stdout.splitlines()
    banner = distributed_init_banner(0, "env://", 0, 1)
    tests = [TEST_LINE.match(ln) for ln in lines if ln.startswith("Test set")]
    train = [TRAIN_LINE.match(ln) for ln in lines if ln.startswith("Train Epoch")]
    steps = rank0["step"]
    check(lines.count(banner) == 1, f"launcher leg: banner {banner!r} not printed once")
    check(rank0["backends"] == ["nccl"], f"launcher leg formed {rank0['backends']}")
    check(len(tests) == 1 and all(tests) and all(train), "launcher leg: malformed lines")
    check(steps == 60000 // DDP_BATCH, f"launcher leg took {steps} steps")
    check(rank0["launches"] == {"adadelta_delta": steps, "adadelta_fused": 0},
          f"launcher leg launches {rank0['launches']} for {steps} steps")
    acc1 = int(tests[0].group(2)) / int(tests[0].group(3))
    check(rank0["timings"]["epoch1_test_accuracy"] == acc1, "the chief's line off its timings")
    saved = torch.load(os.path.join(workdir, "mnist_cnn.pt"), weights_only=True)
    check(all(k.startswith("module.") for k in saved), "mnist_cnn.pt without module. keys")
    want = {k: v.cpu() for k, v in alone["model"].state_dict().items()}
    got = load_inference_state(os.path.join(workdir, "mnist_cnn.pt"))
    equal = sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    check(equal, "the NCCL world of one off mnist.py's fit() with the same flags "
          f"(epoch-1 accuracy {acc1} and {alone['timings']['epoch1_test_accuracy']})")
    check(acc1 >= DDP_EPOCH1_MIN_ACCURACY, f"launcher leg epoch-1 accuracy {acc1}")
    for k in launches:
        launches[k] += rank0["launches"][k]
        references[k] += alone["launches"][k]
    before = dict(af.LAUNCHES)
    profile = ddp_profile(torch, np)
    profile_launches = {k: af.LAUNCHES[k] - before[k] for k in before}
    for k in launches:
        launches[k] += profile_launches[k]
    leg1 = {"seconds_per_epoch": rank0["timings"]["epoch_train_s"],
            "mnist_fit_seconds_per_epoch": alone["timings"]["epoch_train_s"],
            "launcher_wall_seconds": launcher_s, "steps": steps,
            "epoch1_test_accuracy": acc1, "launches": rank0["launches"],
            "logged_losses": [float(m.group(5)) for m in train],
            "equal_to_mnist_fit": equal, "backend": rank0["backends"][0], "profile": profile}

    # (2) the two gloo ranks (run beside (1)), against one rank at twice
    # the batch
    ranks = [torch.load(os.path.join(workdir, f"gloo_rank{r}.pt"), weights_only=False)
             for r in (0, 1)]
    check(all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks),
          f"gloo ranks on {[(r['backend'], r['device']) for r in ranks]}")
    fused_refused = [r["fused_refused"] for r in ranks]
    check(all(msg and "NCCL" in msg for msg in fused_refused),
          f"two gloo ranks on the card ran --fused: {fused_refused}")
    xs_t, ys_t = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    w = torch.ones(2 * DDP_RANK_BATCH, device="cuda")
    # The one-rank steps in f64, and in f32 with the rows of every batch
    # permuted (DDP_ORDERS fixed permutations).
    orders_tool = load_tool("ddp_f32_orders")
    f32_run, f64_run = orders_tool.f32_run, orders_tool.f64_run
    f64_losses, f64_state = f64_run(xs_t, ys_t, "cuda")
    gen = torch.Generator().manual_seed(SEED)
    orders = [f32_run(xs_t, ys_t, "cuda", 1,
                      torch.randperm(2 * DDP_RANK_BATCH, generator=gen).cuda())
              for _ in range(DDP_ORDERS)]
    ways = {}
    for way, pallas, syncbn in DDP_WAYS:
        net = Net(torch.Generator().manual_seed(SEED), use_bn=syncbn).cuda()
        state = make_train_state(net, use_pallas=pallas)
        step = make_train_step(dropout=False, use_pallas=pallas)
        before = dict(af.LAUNCHES)
        ref = []
        for i in range(DDP_STEPS):
            ref.append(step(net, state, xs_t[i], ys_t[i], w, 1.0))
            if i + 1 == DDP_GATE_STEPS:
                ref_gate = {k: v.to("cpu", copy=True) for k, v in net.state_dict().items()}
        ref = torch.stack(ref).cpu()
        for k in launches:
            references[k] += af.LAUNCHES[k] - before[k]
            launches[k] += sum(r[way]["launches"][k] for r in ranks)
        a, b = ranks[0][way], ranks[1][way]
        ranks_equal = all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
        mean_loss = (a["losses"] + b["losses"]) / 2  # equal rows per rank
        ref_state = {k: v.cpu() for k, v in net.state_dict().items()}
        g = DDP_STEPS if syncbn else DDP_GATE_STEPS
        got_gate, want_gate = ((a["state"], ref_state) if syncbn
                               else (a["gate_state"], ref_gate))
        loss_ok = torch.allclose(mean_loss[:g], ref[:g], rtol=DDP_LOSS_RTOL, atol=DDP_LOSS_ATOL)
        gate_diff = max(float((got_gate[k] - want_gate[k]).abs().max()) for k in want_gate)
        param_diff = max(float((a["state"][k] - ref_state[k]).abs().max()) for k in ref_state)
        want_launches = {"adadelta_delta": DDP_STEPS if pallas else 0, "adadelta_fused": 0}
        rel = (mean_loss - ref).abs() / ref.abs()
        ok = {"ranks_equal": ranks_equal, "losses_at_gate": loss_ok,
              "params_at_gate": gate_diff <= DDP_PARAM_ATOL,
              "launches": all(r[way]["launches"] == want_launches for r in ranks)}
        report = {"gate_steps": g, "max_rel_loss_diff_at_gate": float(rel[:g].max()),
                  "max_abs_param_diff_at_gate": gate_diff,
                  "max_rel_loss_diff": float(rel.max()),
                  "rel_loss_diff_by_step": rel.tolist(),
                  "max_abs_param_diff": param_diff,
                  "first_last_loss": [float(ref[0]), float(ref[-1])],
                  "launches_per_rank": [r[way]["launches"] for r in ranks]}
        if not syncbn:
            halves, half_state, half_launches = ddp_two_halves(torch, xs_t, ys_t, pallas)
            for k in launches:
                references[k] += half_launches[k]
            ok["equal_to_one_process"] = (
                torch.equal(torch.stack([a["losses"], b["losses"]], 1), halves)
                and all(torch.equal(a["state"][k], half_state[k]) for k in half_state))
            # The ranks' order and the one rank's against the f64
            # trajectory, after every step (loss) and after the last
            # (parameters).
            runs = [("ranks", mean_loss, a["state"]), ("one_rank", ref, ref_state)]
            runs += [(f"one_rank_rows_permuted_{i}", *run) for i, run in enumerate(orders)]
            far = {name: {"rel_loss_diff_by_step": ((run.double() - f64_losses).abs()
                                                    / f64_losses.abs()).tolist(),
                          "max_abs_param_diff": max(float((st[k].double() - f64_state[k])
                                                          .abs().max()) for k in f64_state)}
                   for name, run, st in runs}
            farthest = max(r["max_abs_param_diff"] for name, r in far.items() if name != "ranks")
            ok["f64_no_farther"] = far["ranks"]["max_abs_param_diff"] <= DDP_F64_RATIO * farthest
            report["from_f64"] = far
        ways[way] = {**report, "ok": ok}
    # --zero on the two gloo ranks: the ranks equal, each way the plain
    # data-parallel way it shards bit for bit, no optimizer kernel
    zero_ways = {}
    for way, held in DDP_ZERO_HELD_TO.items():
        a, b = ranks[0][way], ranks[1][way]
        ref = ranks[0][held]
        zero_ways[way] = {
            "held_to": held, "first_last_loss": [float(a["losses"][0]), float(a["losses"][-1])],
            "max_abs_param_diff_vs_held_to": max(float((a["state"][k] - ref["state"][k])
                                                       .abs().max()) for k in ref["state"]),
            "ok": {"ranks_equal": all(torch.equal(a["state"][k], b["state"][k])
                                      for k in a["state"]),
                   "equal_to_plain_dp": torch.equal(a["losses"], ref["losses"]) and all(
                       torch.equal(a["state"][k], ref["state"][k]) for k in ref["state"]),
                   "no_optimizer_kernel": all(r[way]["launches"] == {k: 0 for k in af.LAUNCHES}
                                              for r in ranks),
                   "finite": bool(torch.isfinite(a["losses"]).all())}}

    # --zero in an NCCL world of one through the launcher, against the plain
    # run in this process: the model and the archive equal, and archives
    # crossing between --zero and plain runs resume equal (the plain
    # archive resumed under --zero in this process, a world of one)
    zdir = os.path.join(workdir, "zero")
    os.makedirs(zdir)
    zflags = ["--batch-size", str(DDP_BATCH), "--epochs", "1", "--train-limit",
              str(DDP_ZERO_LIMIT)]
    arch = {name: os.path.join(zdir, f"{name}.npz")
            for name in ("plain", "zero", "zero_resumed_plain", "plain_resumed_zero",
                         "plain_resumed_plain")}
    before = dict(af.LAUNCHES)
    plain_run = fit_run([*zflags, "--save-state", arch["plain"]])

    def zero_launcher(tag, *extra):
        out = os.path.join(zdir, f"counts_{tag}")
        proc = subprocess.run(
            [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
             "--nproc_per_node=1", f"--master_port={free_port()}", os.path.abspath(__file__),
             "--ddp-rank", out, *zflags, "--zero", *extra],
            cwd=zdir, env=env, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"--zero launcher leg {tag} exited {proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")
        with open(out + ".rank0") as f:
            return json.load(f), [ln for ln in proc.stdout.splitlines()
                                  if ln.startswith(("Train Epoch", "Test set"))]

    zrank, zlines = zero_launcher("save", "--save-model", "--save-state", arch["zero"])
    # the plain archive resumed under --zero, in this process (a world of one)
    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser as ddp_parser
    from pytorch_mnist_ddp_tpu_torch.trainer import fit

    with contextlib.redirect_stdout(io.StringIO()):
        _, zstate = fit(ddp_parser().parse_args([*zflags, "--zero", "--resume-state", arch["plain"],
                                                 "--save-state", arch["plain_resumed_zero"]]),
                        "cuda")
    resumed = fit_run([*zflags, "--resume-state", arch["plain"], "--save-state",
                       arch["plain_resumed_plain"]])
    fit_run([*zflags, "--resume-state", arch["zero"], "--save-state",
             arch["zero_resumed_plain"]])
    for k in references:
        references[k] += af.LAUNCHES[k] - before[k]

    zmodel = load_inference_state(os.path.join(zdir, "mnist_cnn.pt"))
    pmodel = {k: v.cpu() for k, v in plain_run["model"].state_dict().items()}
    zero_nccl = {
        "steps": zrank["step"], "epoch_s": zrank["timings"]["epoch_train_s"],
        "plain_epoch_s": plain_run["timings"]["epoch_train_s"],
        "ok": {"backend_nccl": zrank["backends"] == ["nccl"],
               "model_equal_to_plain_fit": sorted(zmodel) == sorted(pmodel) and all(
                   torch.equal(zmodel[k], pmodel[k]) for k in pmodel),
               "lines_equal_to_plain_fit": zlines == [
                   ln for ln in plain_run["lines"] if ln.startswith(("Train Epoch",
                                                                     "Test set"))],
               "archive_equal_to_plain": same_archive(np, arch["zero"], arch["plain"]),
               "plain_archive_resumed_under_zero": same_archive(
                   np, arch["plain_resumed_zero"], arch["plain_resumed_plain"]),
               "zero_archive_resumed_plain": same_archive(
                   np, arch["zero_resumed_plain"], arch["plain_resumed_plain"]),
               "resumed_steps": resumed["state"].step == zstate.step == 2 * zrank["step"],
               "no_optimizer_kernel": zrank["launches"] == {k: 0 for k in af.LAUNCHES}}}

    # Row 3 once a --pallas-opt step: the data-parallel step on the
    # launcher's rank, in the profiled world and on both gloo ranks; the
    # references in this process (fit(), one rank at 64, the halves).
    pallas_ways = sum(pallas for _, pallas, _ in DDP_WAYS)
    pallas_plain = sum(pallas for _, pallas, bn in DDP_WAYS if not bn)
    want = steps + profile["steps_taken"] + DDP_STEPS * 2 * pallas_ways
    want_ref = alone["state"].step + DDP_STEPS * (pallas_ways + pallas_plain)
    local = {k: af.LAUNCHES[k] - start[k] for k in start}
    emit({"phase": "ddp", "nccl_world_of_one": leg1,
          "gloo_two_ranks_one_card": {"steps": DDP_STEPS, "rank_batch": DDP_RANK_BATCH,
                                      "wall_seconds": gloo_s, "ways": ways,
                                      "zero_ways": zero_ways,
                                      "fused_refused": fused_refused[0]},
          "zero_nccl_world_of_one": zero_nccl,
          "seconds": time.perf_counter() - t_phase, "launches": launches,
          "reference_launches": references})
    for way, report in {**ways, **zero_ways, "zero_nccl_world_of_one": zero_nccl}.items():
        check(all(report["ok"].values()), f"ddp {way}: {report['ok']}")
    check(launches == {"adadelta_delta": want, "adadelta_fused": 0},
          f"ddp phase launches {launches}, --pallas-opt steps {want}")
    check(references == {"adadelta_delta": want_ref, "adadelta_fused": 0},
          f"ddp references' launches {references}, --pallas-opt steps {want_ref}")
    check(local == {k: profile_launches[k] + references[k] for k in local},
          f"ddp phase launched {local} in this process outside its legs")
    return launches, references


def flash_inputs(torch, np, shape, seed: int, strided: bool = True, offset: int = 0,
                 dtype=None):
    """q, k, v ``[b, t, h, d]`` on the card, float32 unless ``dtype``: by
    default strided views of one ``[b, t, h, 3, d]`` tensor, as the ViT's
    head-major qkv hands them over; else three contiguous tensors.
    ``offset`` starts each allocation's data that many elements in."""
    b, t, h, d = shape
    dtype = dtype or torch.float32
    rng = np.random.RandomState(seed)

    def card(shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
        buf = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")
        buf[offset:].copy_(x.reshape(-1))
        return buf[offset:].view(shape)

    if strided:
        qkv = card((b, t, h, 3, d))
        return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    return tuple(card((b, t, h, d)) for _ in range(3))


def flash_random_state(torch, np, b: int, h: int, t: int, d: int, seed: int):
    """A ring state (m, l, a) with finite m and l > 0, except every seventh
    row, left empty (m = -1e30, l = 0, a = 0) as after only masked keys."""
    rng = np.random.RandomState(seed)
    m = (2 * rng.randn(b * h * t)).astype(np.float32)
    l = (rng.rand(b * h * t) * 3 + 0.1).astype(np.float32)
    a = rng.randn(b * h * t, d).astype(np.float32)
    m[::7], l[::7], a[::7] = -1e30, 0.0, 0.0
    return tuple(torch.from_numpy(x).cuda().reshape(shape)
                 for x, shape in ((m, (b, h, t)), (l, (b, h, t)), (a, (b, h, t, d))))


def flash_close(torch, got, want, what: str, rtol: float = FLASH_RTOL,
                atol: float = FLASH_ATOL) -> tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and the largest share of the
    gate it uses, max |got - want| / (atol + rtol |want|); fails past 1."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what} non-finite")
    err = float((got - want).abs().max())
    share = float(((got - want).abs() / (atol + rtol * want.abs())).max())
    check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
          f"{what} off its plain version by {err}")
    return err, share


def flash_f64_errors(torch, state, q, k, v, results: dict, scale: float = 1.0) -> dict:
    """Each of ``results`` (partial-mode states) against the same fold in
    f64: m's max abs error, and l's and a / l's largest share of the gate
    (the f32 gate times ``scale``)."""
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa

    m, l, a = (x.double() for x in state)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * fa._scale(q.shape[-1])
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    a_new = a * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.double())
    del s, p

    def share(got, want):
        gate = scale * (FLASH_ATOL + FLASH_RTOL * want.abs())
        return float(((got.double() - want).abs() / gate).max())

    return {name: {"m_abs": float((r.m.double() - m_new).abs().max()), "l": share(r.l, l_new),
                   "a/l": share(r.o / r.l[..., None], a_new / l_new[..., None])}
            for name, r in results.items()}


def flash_kernel_phase(torch, np) -> dict[str, dict[str, float]]:
    """Both modes against the plain version at every shape, in f32 and in
    bf16; the partial mode from the empty and from a random state, and in
    place.  Returns the worst error per kernel name and dtype."""
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    worst = {name: {"float32": 0.0, "bfloat16": 0.0} for name in ("flash_fwd", "flash_partial")}
    cases = ([(kind, shape, True, 0, f32) for kind, shape in FLASH_MAIN.items()]
             + [("odd", shape, True, 0, f32) for shape in FLASH_ODD]
             + [("odd_contiguous", FLASH_ODD[-1], False, 0, f32)]
             + [("offset", shape, True, 1, f32) for shape in FLASH_OFFSET]
             + [("wide", FLASH_WIDE, True, 0, f32)]
             + [("long", shape, True, 0, f32) for shape in FLASH_LONG]
             + [("bf16 " + kind, shape, True, 0, bf16) for kind, shape in FLASH_MAIN.items()]
             + [("bf16 long", shape, True, 0, bf16) for shape in FLASH_LONG]
             + [("bf16 offset", shape, True, 1, bf16) for shape in FLASH_OFFSET]
             + [(f"{dt_name}d={shape[3]}", shape, True, 0, dt)
                for shape in FLASH_WIDE_D for dt_name, dt in (("", f32), ("bf16 ", bf16))]
             + [(f"{dt_name}parallel", shape, True, 0, dt)
                for shape in FLASH_PARALLEL for dt_name, dt in (("", f32), ("bf16 ", bf16))])
    report, vs_f64 = {}, {}
    for i, (kind, shape, strided, offset, dtype) in enumerate(cases):
        b, t, h, d = shape
        where = f"{kind} {'x'.join(map(str, shape))}"
        dt = str(dtype).split(".")[-1]
        # bf16 outputs within about one bf16 ulp; f32 ones (and past d = 128
        # scaled by d / 64) at the f32 gate
        scale = d / 64 if d > 128 else 1.0
        f32_gate = dict(rtol=scale * FLASH_RTOL, atol=scale * FLASH_ATOL)
        out_gate = (dict(rtol=FLASH_BF16_RTOL, atol=FLASH_BF16_ATOL) if dtype == bf16
                    else f32_gate)
        q, k, v = flash_inputs(torch, np, shape, i, strided, offset, dtype)
        out, lse = fa.flash_fwd(q, k, v)
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v)
        torch.cuda.synchronize()
        check(out.dtype == dtype and lse.dtype == f32, f"flash_fwd dtypes at {where}")
        errs, shares = {}, {}
        for name, got, want, gate in (("fwd_out", out, ref_out, out_gate),
                                      ("fwd_lse", lse, ref_lse, f32_gate)):
            errs[name], shares[name] = flash_close(torch, got, want,
                                                   f"flash_fwd {name} at {where}", **gate)
        worst["flash_fwd"][dt] = max(worst["flash_fwd"][dt], errs["fwd_out"], errs["fwd_lse"])
        for start in ("empty", "random"):
            state = (fa.flash_ring_state(b, h, t, d, "cuda") if start == "empty"
                     else flash_random_state(torch, np, b, h, t, d, 1000 + i))
            got = fa.flash_partial(*state, q, k, v)
            want = fa.flash_partial_reference(*state, q, k, v)
            if start == "random" and dtype == f32 and (shape == FLASH_LONG[-1] or d > 128):
                vs_f64[where] = flash_f64_errors(torch, state, q, k, v,
                                                 {"kernel": got, "plain": want}, scale)
            aliased = fa.flash_partial(*state, q, k, v, inplace=True)
            torch.cuda.synchronize()
            check(all(x is y for x, y in zip(aliased, state)), "in-place partial returned copies")
            check(all(torch.equal(x, y) for x, y in zip(aliased, got)),
                  f"in-place partial differs from the fresh one at {where}")
            what = f"flash_partial ({start}) at {where}"
            check(bool(torch.isfinite(got.o).all()), f"{what}: a non-finite")
            # One key at least was folded into every row, so l > 0.
            err = 0.0
            for name, g, w, gate in (("m", got.m, want.m, f32_gate), ("l", got.l, want.l, f32_gate),
                                     ("a/l", got.o / got.l[..., None], want.o / want.l[..., None],
                                      out_gate)):
                e, sh = flash_close(torch, g, w, f"{what}: {name}", **gate)
                err, shares[name] = max(err, e), max(shares.get(name, 0.0), sh)
            errs[f"partial_{start}"] = err
            errs[f"partial_{start}_raw_a"] = float((got.o - want.o).abs().max())
            worst["flash_partial"][dt] = max(worst["flash_partial"][dt], err)
        report[where] = {"max_abs_err": errs, "share_of_gate": shares}
    emit({"phase": "kernel", "name": "flash_attention",
          "gate": {"float32": {"rtol": FLASH_RTOL, "atol": FLASH_ATOL,
                               "past_d_128": "times d / 64"},
                   "bfloat16": {"out, a/l": {"rtol": FLASH_BF16_RTOL, "atol": FLASH_BF16_ATOL},
                                "lse, m, l": "the float32 gate"}},
          "partial_held_as": "m, l, a / l (raw a recorded: it sums t unnormalized terms)",
          "share_of_gate": "max |kernel - plain| / (atol + rtol |plain|) per quantity; 1 fails",
          "by_shape": report, "vs_f64 (random state; share of the case's f32 gate)": vs_f64})
    return worst


def vit_step_phase(torch, np) -> tuple[dict[str, int], dict[str, int]]:
    """VIT_STEPS ViT steps seven ways (four f32, three --bf16) from one set
    of weights on fixed batches; returns the flash launches of the phase,
    all and those of the --bf16 runs."""
    from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
    from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
    from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.ops.adadelta import adadelta_init
    from pytorch_mnist_ddp_tpu_torch.parallel import sp
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import TrainState, make_forward_train_step

    batch = 64
    images, labels = synthetic_mnist("train", VIT_STEPS * batch)
    xs = torch.from_numpy(normalize(images)).cuda().reshape(VIT_STEPS, batch, 28, 28, 1)
    ys = torch.from_numpy(labels.astype(np.int64)).cuda().reshape(VIT_STEPS, batch)
    w = torch.ones(batch, device="cuda")
    init = ViT(generator=torch.Generator().manual_seed(SEED)).state_dict()
    calls = ViTConfig().depth * VIT_STEPS  # attention calls in the forwards
    want = {"plain": {"flash_fwd": 0, "flash_partial": 0},
            "flash": {"flash_fwd": calls, "flash_partial": 0},
            "sp1_flash": {"flash_fwd": 0, "flash_partial": calls},
            "flash_remat": {"flash_fwd": 2 * calls, "flash_partial": 0},  # + the recompute
            "bf16_plain": {"flash_fwd": 0, "flash_partial": 0},
            "bf16_flash": {"flash_fwd": calls, "flash_partial": 0},
            "bf16_sp1_flash": {"flash_fwd": 0, "flash_partial": calls}}
    runs = {}
    for run in want:
        base = run.removeprefix("bf16_")
        model = ViT(ViTConfig(remat=base == "flash_remat", bf16=run.startswith("bf16_")),
                    fa.select_attention(base != "plain")).cuda()
        model.load_state_dict(init)
        state = TrainState(opt=adadelta_init(dict(model.named_parameters())))
        if base == "sp1_flash":
            step = sp.make_sp_train_step(model.cfg, use_flash=True)
        else:
            step = make_forward_train_step(lambda m, x: m(x))
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        losses = torch.stack([step(model, state, xs[i], ys[i], w, 1.0)
                              for i in range(VIT_STEPS)])
        torch.cuda.synchronize()
        runs[run] = {
            "seconds": time.perf_counter() - t0,
            "losses": losses.cpu().numpy(),
            "params": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
            "launches": {k: fa.LAUNCHES[k] - before[k] for k in before},
        }
    report = {}
    for run, r in runs.items():
        check(r["launches"] == want[run], f"vit_step {run} launches {r['launches']} != {want[run]}")
        check(all(p.dtype == np.float32 for p in r["params"].values()),
              f"vit_step {run}: parameters not float32")
        # each run against the plain run of its dtype
        plain = runs["bf16_plain" if run.startswith("bf16_") else "plain"]
        if r is plain:
            check(np.isfinite(r["losses"]).all(), f"{run} vit_step losses non-finite")
            check(r["losses"][-1] < r["losses"][0], f"{run} vit_step did not learn")
            continue
        loss_diff = float(np.abs(r["losses"] - plain["losses"]).max())
        param_diff = max(float(np.abs(r["params"][k] - plain["params"][k]).max())
                         for k in plain["params"])
        if plain is runs["plain"]:
            check(np.allclose(r["losses"], plain["losses"], rtol=VIT_STEP_RTOL, atol=0),
                  f"vit_step {run} losses off the plain run by {loss_diff}")
            check(param_diff <= VIT_STEP_ATOL, f"vit_step {run} params off the plain run by "
                  f"{param_diff}")
        else:
            check(loss_diff <= VIT_BF16_STEP_ATOL and param_diff <= VIT_BF16_STEP_ATOL,
                  f"vit_step {run} off the bf16 plain run: loss {loss_diff}, params {param_diff}")
        report[run] = {"max_abs_loss_diff": loss_diff, "max_abs_param_diff": param_diff,
                       "launches": r["launches"], "seconds": r["seconds"]}
    plain = runs["plain"]
    remat_equal = all(np.array_equal(runs["flash_remat"]["params"][k], runs["flash"]["params"][k])
                      for k in plain["params"])
    bf16_plain = runs["bf16_plain"]
    emit({"phase": "vit_step", "steps": VIT_STEPS, "loss_rtol": VIT_STEP_RTOL,
          "param_atol": VIT_STEP_ATOL, "bf16_loss_and_param_atol": VIT_BF16_STEP_ATOL,
          "plain_first_last_loss": [float(plain["losses"][0]), float(plain["losses"][-1])],
          "bf16_plain_first_last_loss": [float(bf16_plain["losses"][0]),
                                         float(bf16_plain["losses"][-1])],
          "bf16_plain_vs_plain": {
              "max_abs_loss_diff": float(np.abs(bf16_plain["losses"] - plain["losses"]).max()),
              "max_abs_param_diff": max(float(np.abs(bf16_plain["params"][k]
                                                     - plain["params"][k]).max())
                                        for k in plain["params"])},
          "plain_seconds": plain["seconds"], "bf16_plain_seconds": bf16_plain["seconds"],
          "flash_remat_equals_flash": remat_equal,
          "vs_plain_of_its_dtype": report})
    return ({k: sum(r["launches"][k] for r in runs.values()) for k in plain["launches"]},
            {k: sum(r["launches"][k] for run, r in runs.items() if run.startswith("bf16_"))
             for k in plain["launches"]})


def vit_train_phase(torch, np, workdir: str) -> tuple[dict[str, int], dict[str, int], dict]:
    """The ViT CLI's fit() on the card, one epoch each of --flash, --sp 1
    --allow-degree-1 --flash, and both with --bf16: a full epoch of --flash
    and of --bf16 --sp 1 --allow-degree-1 --flash (the accuracy floor on
    each dtype and each path), the other two on VIT_CUT_ROWS training rows
    of an IDX set; returns the flash launches of the phase, all and those
    of the --bf16 legs, and the cut --sp 1 leg's record (its logged losses
    and test line), which vit_parallel's --sp 2 epoch is held to."""
    from pytorch_mnist_ddp_tpu_torch import vit_mnist
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa

    launches = {k: 0 for k in fa.LAUNCHES}
    bf16_launches = dict(launches)
    legs = {}
    cut = ["--data-root", vit_idx_root(np, workdir, VIT_CUT_ROWS, "vit_cut_idx")]
    for leg, mode, flags in (
        ("flash", "flash_fwd", ["--epochs", "1", "--flash"]),
        ("sp1_flash", "flash_partial", ["--epochs", "1", "--sp", "1", "--allow-degree-1",
                                        "--flash", *cut]),
        ("bf16_flash", "flash_fwd", ["--epochs", "1", "--bf16", "--flash", *cut]),
        ("bf16_sp1_flash", "flash_partial", ["--epochs", "1", "--bf16", "--sp", "1",
                                             "--allow-degree-1", "--flash"]),
    ):
        args = vit_mnist.build_parser().parse_args(flags)
        timings: dict = {}
        before = dict(fa.LAUNCHES)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            model, state = vit_mnist.fit(args, vit_mnist.resolve_mode_flags(args), "cuda",
                                         timings=timings)
        wall = time.perf_counter() - t0
        got = {k: fa.LAUNCHES[k] - before[k] for k in before}
        for k in launches:
            launches[k] += got[k]
            bf16_launches[k] += got[k] if "--bf16" in flags else 0
        lines = [ln for ln in out.getvalue().splitlines() if ln]
        train = [TRAIN_LINE.match(ln) for ln in lines if ln.startswith("Train Epoch")]
        tests = [TEST_LINE.match(ln) for ln in lines if ln.startswith("Test set")]
        check(all(train) and all(tests), f"vit {leg}: malformed lines")
        other = [ln for ln in lines if not ln.startswith(("Train Epoch", "Test set", "MNIST IDX"))]
        check(not other, f"vit {leg}: unexpected output {other[:3]}")
        losses = [float(m.group(5)) for m in train]
        steps = sum(timings["epoch_steps"])
        eval_batches = -(-timings["test_size"] // args.test_batch_size)
        calls = model.cfg.depth * (steps + args.epochs * eval_batches)
        want = {k: calls if k == mode else 0 for k in fa.LAUNCHES}
        check(got == want, f"vit {leg}: launches {got} != attention calls {want}")
        check(len(tests) == args.epochs, f"vit {leg}: {len(tests)} test summaries")
        check(all(math.isfinite(x) for x in losses), f"vit {leg}: non-finite loss")
        check(losses[-1] < losses[0], f"vit {leg}: last logged loss {losses[-1]} not below "
              f"the first {losses[0]}")
        check(next(model.parameters()).device.type == "cuda", f"vit {leg}: model not on the card")
        check(model.cfg.bf16 == ("--bf16" in flags), f"vit {leg}: bf16 {model.cfg.bf16}")
        check(state.step == steps, f"vit {leg}: {state.step} optimizer steps, loader gave {steps}")
        acc1 = timings["epoch1_test_accuracy"]
        check("--data-root" in flags or acc1 >= VIT_EPOCH1_MIN_ACCURACY,
              f"vit {leg}: epoch-1 test accuracy {acc1} < {VIT_EPOCH1_MIN_ACCURACY}")
        secs = timings["epoch_train_s"]
        legs[leg] = {
            "dataset": timings["dataset"], "train_size": timings["train_size"],
            "epochs": args.epochs, "steps_per_epoch": timings["epoch_steps"],
            "train_seconds_per_epoch": secs,
            "images_per_s": [n * args.batch_size / t for n, t in zip(timings["epoch_steps"], secs)],
            "test_accuracy_by_epoch": [int(m.group(2)) / int(m.group(3)) for m in tests],
            "test_loss_by_epoch": [float(m.group(1)) for m in tests],
            "first_last_logged_loss": [losses[0], losses[-1]],
            "wall_seconds": wall, "launches": got, "attention_calls": calls,
        }
        if "--data-root" in flags:
            legs[leg]["logged_losses"] = losses
    emit({"phase": "vit_train", "epoch1_min_accuracy": VIT_EPOCH1_MIN_ACCURACY,
          "cut_to_train_rows": {"rows": VIT_CUT_ROWS, "legs": ["sp1_flash", "bf16_flash"]},
          "jax_cpu_epoch1_accuracy": {"f32": [0.7918, 0.8100, 0.7974], "bf16": [0.7882, 0.8426, 0.7591],
                                      "seeds": [1, 2, 3]},
          "legs": legs})
    return launches, bf16_launches, legs["sp1_flash"]


def vit_fused_phase(torch, np, workdir: str) -> dict:
    """The ViT's fused path on the card (docstring, 14b), TF32 off.
    (c)'s bench and (b)'s NCCL world of one run in processes of their own,
    started first and waited for before (d)'s profiled window.  Returns
    the phase's record."""
    import itertools
    import os

    from pytorch_mnist_ddp_tpu_torch import vit_mnist
    from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
    from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
    from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
    from pytorch_mnist_ddp_tpu_torch.ops.adadelta import adadelta_init
    from pytorch_mnist_ddp_tpu_torch.parallel import fused
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import TrainState, make_forward_train_step
    from pytorch_mnist_ddp_tpu_torch.parallel.fused_vit import make_fused_vit_run
    from pytorch_mnist_ddp_tpu_torch.parallel.mesh import Group
    from pytorch_mnist_ddp_tpu_torch.parallel.zero import zero_init

    t_phase = time.perf_counter()
    counts = lambda: {"int8_head": ih.LAUNCHES, **af.LAUNCHES, **fa.LAUNCHES}  # noqa: E731
    start = counts()
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    cut = vit_idx_root(np, workdir, VIT_CUT_ROWS, "vit_cut_idx")
    zero_archive = os.path.join(workdir, "fused_zero.npz")
    t_procs = time.perf_counter()
    procs = {
        "bench": subprocess.Popen(
            [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.tools.vit_bench", "--mode",
             "fused", "--epochs", "1"], cwd=workdir, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "nccl_zero": subprocess.Popen(
            [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
             "--nproc_per_node=1", f"--master_port={free_port()}", "-m",
             "pytorch_mnist_ddp_tpu_torch.vit_mnist", "--fused", "--zero", "--epochs", "1",
             "--data-root", cut, "--save-state", zero_archive], cwd=workdir, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    try:
        # (a) captured against eager, from the same weights on the same batches
        images, labels = synthetic_mnist("train")
        loader = DataLoader(images, labels, 64, torch.device("cuda"), seed=1)
        test_images, test_labels = synthetic_mnist("test", 1000)
        test_loader = DataLoader(test_images, test_labels, 1000, torch.device("cuda"),
                                 shuffle=False, mask_padding=True)
        steps = fused.WARMUP_STEPS + VIT_FUSED_CAPTURED
        init = ViT(generator=torch.Generator().manual_seed(SEED)).state_dict()

        def fresh(cfg: ViTConfig, zero: bool):
            model = ViT(cfg).cuda()
            model.load_state_dict(init)
            params = dict(model.named_parameters())
            return model, TrainState(opt=zero_init(params, Group()) if zero
                                     else adadelta_init(params))

        captured = {}
        for leg, cfg, zero in (("plain", ViTConfig(), False), ("bf16", ViTConfig(bf16=True), False),
                               ("remat", ViTConfig(remat=True), False),
                               ("zero", ViTConfig(), True)):
            model, state = fresh(cfg, zero)
            step = make_forward_train_step(lambda m, x: m(x))
            eager = torch.stack([step(model, state, x, y, w, 1.0)
                                 for x, y, w in itertools.islice(loader.epoch(1), steps)])
            fmodel, fstate = fresh(cfg, zero)
            run = make_fused_vit_run(fmodel, fstate, loader, test_loader).train
            run.load(1, 1.0)
            for _ in range(steps):
                run.step()
            torch.cuda.synchronize()
            same = {"params": all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                                    fmodel.parameters())),
                    "accumulators": same_opt(torch, state.opt, fstate.opt),
                    "losses": torch.equal(eager, run.losses[:steps]),
                    "step": state.step == fstate.step == steps}
            captured[leg] = {"eager_steps": run.eager_steps, "replays": run.replays,
                             "capture_s": run.capture_s, "torch_equal": same}
            check(all(same.values()), f"vit_fused (a) {leg}: the captured steps off the eager: "
                  f"{same}")
            check(run.graph is not None and run.replays == VIT_FUSED_CAPTURED,
                  f"vit_fused (a) {leg}: {run.replays} replays")
        del loader

        # (b) the CLI: one full epoch with --timings-json, then the cut epoch
        # three ways
        def fit(flags: list[str]) -> dict:
            args = vit_mnist.build_parser().parse_args(flags)
            timings: dict = {}
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                model, state = vit_mnist.fit(args, vit_mnist.resolve_mode_flags(args), "cuda",
                                             timings=timings)
            return {"wall": time.perf_counter() - t0, "timings": timings, "model": model,
                    "state": state, "lines": log_lines(out.getvalue().splitlines())}

        timings_path = os.path.join(workdir, "vit_timings.json")
        full = fit(["--epochs", "1", "--fused", "--timings-json", timings_path])
        with open(timings_path) as f:
            written = json.load(f)
        t = full["timings"]
        acc1 = t["epoch1_test_accuracy"]
        check(tuple(written) == vit_mnist.TIMINGS_KEYS, f"vit_fused (b): timings keys {written}")
        check(written["compile_s"] > 0 and 0 < written["run_s"] < full["wall"],
              f"vit_fused (b): compile_s {written['compile_s']}, run_s {written['run_s']}, "
              f"wall {full['wall']}")
        check(acc1 >= VIT_EPOCH1_MIN_ACCURACY, f"vit_fused (b): epoch-1 accuracy {acc1}")
        check(t["host_syncs"] == 1 and t["replays"] == t["epoch_steps"][0] - fused.WARMUP_STEPS,
              f"vit_fused (b): {t['host_syncs']} host reads, {t['replays']} replays in "
              f"{t['epoch_steps']} steps")
        per_batch_archive = os.path.join(workdir, "per_batch.npz")
        cut_flags = ["--epochs", "1", "--data-root", cut]
        per_batch = fit([*cut_flags, "--save-state", per_batch_archive])
        gather = fit([*cut_flags, "--fused"])
        pregather = fit([*cut_flags, "--fused", "--pregather"])
        same_cut = {}
        for name, r in (("fused", gather), ("pregather", pregather)):
            same_cut[name] = {
                "lines": r["lines"] == per_batch["lines"],
                "params": all(torch.equal(a, b) for a, b in zip(r["model"].parameters(),
                                                                per_batch["model"].parameters())),
                "accumulators": same_opt(torch, r["state"].opt, per_batch["state"].opt),
                "step": r["state"].step == per_batch["state"].step}
        check(all(v for d in same_cut.values() for v in d.values()),
              f"vit_fused (b): the cut epoch off the per-batch one: {same_cut}")
    finally:
        in_process_s = time.perf_counter() - t_phase
        # the shorter first, so that each wait ends at its own process's exit
        waited = {name: waited_process(procs[name], t_procs, timeout=300)
                  for name in ("nccl_zero", "bench")}
    rc, out, err, zero_s = waited["nccl_zero"]
    check(rc == 0, f"vit_fused (b) the NCCL world of one exited {rc}: {err[-3000:]}")
    same_nccl = {"lines": log_lines(out.splitlines()) == per_batch["lines"],
                 "archive": same_archive(np, zero_archive, per_batch_archive)}
    check(all(same_nccl.values()), f"vit_fused (b): --fused --zero in the NCCL world of one off "
          f"the per-batch epoch: {same_nccl}")
    # (c) the bench
    rc, out, err, bench_s = waited["bench"]
    lines = out.splitlines()
    check(rc == 0 and len(lines) == 1, f"vit_fused (c): vit_bench exited {rc}: {out[-2000:]} "
          f"{err[-2000:]}")
    row = json.loads(lines[0])
    check(0 < row.get("mfu", 0) < 1, f"vit_fused (c): vit_bench's row {row}")

    # (d) where a replayed step's time goes, alone on the card
    images, labels = synthetic_mnist("train")
    loader = DataLoader(images, labels, 64, torch.device("cuda"), seed=1)
    model = ViT(generator=torch.Generator().manual_seed(SEED)).cuda()
    run = make_fused_vit_run(model, TrainState(opt=adadelta_init(dict(model.named_parameters()))),
                             loader, test_loader).train
    run.load(1, 1.0)
    for _ in range(fused.WARMUP_STEPS + 10):  # the capture, then a few replays
        run.step()
    torch.cuda.synchronize()
    profile = profile_window(torch, [(None, None, None)] * VIT_FUSED_PROFILE_STEPS,
                             lambda *_: run.step())
    check(run.replays == 10 + VIT_FUSED_PROFILE_STEPS, f"vit_fused (d): {run.replays} replays")
    launched = {k: v - start[k] for k, v in counts().items()}
    check(not any(launched.values()), f"vit_fused: a kernel of the table launched: {launched}")
    record = {
        "phase": "vit_fused", "captured_vs_eager": captured,
        "cli": {"seconds_per_epoch": t["epoch_wall_s"], "wall_seconds": full["wall"],
                "timings_json": written, "host_syncs_per_epoch": t["host_syncs"],
                "replays": t["replays"], "epoch1_test_accuracy": acc1,
                "cut_torch_equal_to_per_batch": same_cut,
                "cut_seconds_per_epoch": {name: r["timings"]["epoch_wall_s"] for name, r in (
                    ("per_batch", per_batch), ("fused", gather), ("pregather", pregather))},
                "cut_per_batch_train_seconds": per_batch["timings"]["epoch_train_s"],
                "nccl_world_of_one_zero": {**same_nccl, "process_seconds": zero_s}},
        "vit_bench": {**row, "process_seconds": bench_s},
        "profile_replay": profile, "launches": launched,
        "in_process_seconds_before_the_wait": in_process_s,
        "seconds": time.perf_counter() - t_phase}
    emit(record)
    return record


def vit_profile_phase(torch) -> None:
    """Where a ViT training step's time goes: VIT_PROFILE_STEPS steps on
    fixed batches under torch.profiler, plain, --flash, --sp 1 --allow-degree-1
    --flash and --bf16 --flash."""
    from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig
    from pytorch_mnist_ddp_tpu_torch.ops.adadelta import adadelta_init
    from pytorch_mnist_ddp_tpu_torch.ops.flash_attention import select_attention
    from pytorch_mnist_ddp_tpu_torch.parallel import sp
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import TrainState, make_forward_train_step

    batches, _ = loader_batches(torch)
    report = {}
    for name in ("plain", "flash", "sp1_flash", "bf16_flash"):
        model = ViT(ViTConfig(bf16=name == "bf16_flash"), select_attention(name != "plain"),
                    generator=torch.Generator().manual_seed(SEED)).cuda()
        state = TrainState(opt=adadelta_init(dict(model.named_parameters())))
        if name == "sp1_flash":
            step = sp.make_sp_train_step(model.cfg, use_flash=True)
        else:
            step = make_forward_train_step(lambda m, x: m(x))
        for x, y, w in batches[:10]:  # warm-up
            step(model, state, x, y, w, 1.0)
        torch.cuda.synchronize()
        report[name] = profile_window(torch, batches[10:10 + VIT_PROFILE_STEPS],
                                      lambda x, y, w: step(model, state, x, y, w, 1.0))
    emit({"phase": "vit_profile", **report})


def flash_bound(mode: str, shape, bf16: bool = False) -> tuple[float, str, float]:
    """Least time (ms) for one call: q, k, v read once and out + lse written
    once (fwd), or q, k, v and the f32 state read once and the state written
    once (partial), against the 4*b*h*t^2*d operations of the two products.
    f32 inputs: the products run as 3xTF32 (three TF32 passes per product at
    the tensor cores' rate), the cheapest route on the card to f32-accurate
    products, since one TF32 pass misses the f32 gate.  bf16 inputs (2
    bytes an element; lse and the state stay f32): one bf16 pass at 989
    TFLOP/s.  Also returns the bound with the products on the f32 CUDA
    cores (ms)."""
    b, t, h, d = shape
    n, rows = b * t * h * d, b * h * t
    elem = 2 if bf16 else 4
    out = elem * n + 4 * rows if mode == "flash_fwd" else 4 * 2 * (2 * rows + n)
    nbytes = elem * 3 * n + out
    ops = 4 * b * h * t * t * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / BF16_OPS_PER_S if bf16 else 3 * ops / TF32_OPS_PER_S
    f32_ms = 1e3 * max(t_bytes, ops / F32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", f32_ms


def ptxas_entries(report: str) -> dict[str, dict]:
    """Per kernel in an ``nvcc -Xptxas=-v`` report: the target, registers,
    spill stores and static shared memory (dynamic shared memory is set at
    launch and not in the report)."""
    entries = {}
    for chunk in report.split("Compiling entry function ")[1:]:
        head = re.match(r"'(\w+)' for '(\w+)'", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        if head and regs:
            entries[head.group(1)] = {
                "arch": head.group(2), "registers": int(regs.group(1)),
                "spill_store_bytes": int(spill.group(1)) if spill else None,
                "static_smem_bytes": int(smem.group(1)) if smem else 0,
            }
    return entries


def sdpa_backend(torch, q, k, v) -> str:
    """The backend scaled_dot_product_attention picks for these inputs."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v)).name


def flash_times(torch, np) -> dict[str, dict]:
    """Both modes, their plain versions and scaled_dot_product_attention at
    the ViT's shapes and the long ones, in f32 and in bf16 (rows named
    "bf16 ..."), back to back (warm)."""
    import torch.nn.functional as F

    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa

    out = {"flash_fwd": {}, "flash_partial": {}}
    ratios = {"flash_fwd": {}, "flash_partial": {}}
    f32_bounds = {"flash_fwd": {}, "flash_partial": {}}
    library_backends = {}
    shapes = (list(FLASH_MAIN.items()) + [("long", shape) for shape in FLASH_LONG]
              + [(f"d={shape[3]}", shape) for shape in FLASH_WIDE_D])
    shapes = [(kind, shape, False) for kind, shape in shapes] + [
        ("bf16 " + kind, shape, True) for kind, shape in shapes]
    for i, (kind, shape, bf16) in enumerate(shapes):
        b, t, h, d = shape
        where = f"{kind} {'x'.join(map(str, shape))}"
        q, k, v = flash_inputs(torch, np, shape, 100 + i,
                               dtype=torch.bfloat16 if bf16 else torch.float32)
        m, l, a = fa.flash_ring_state(b, h, t, d, "cuda")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt)

        library_ms = median_ms(torch, library)
        library_backends[where] = sdpa_backend(torch, qt, kt, vt)
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v),
                          lambda: fa.flash_fwd_reference(q, k, v)),
            "flash_partial": (lambda: fa.flash_partial(m, l, a, q, k, v),
                              lambda: fa.flash_partial_reference(m, l, a, q, k, v)),
        }
        for mode, (kernel, plain) in calls.items():
            bound_ms, bound_by, f32_bounds[mode][where] = flash_bound(mode, shape, bf16)
            ms = median_ms(torch, kernel)
            out[mode][where] = {"ms": ms, "plain_ms": median_ms(torch, plain),
                                "library_ms": library_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by}
            ratios[mode][where] = {"share_of_bound": bound_ms / ms, "vs_library": ms / library_ms}
    one = torch.zeros(1, device="cuda")
    floor_ms = median_ms(torch, lambda: one.add_(1.0))
    emit({"phase": "times", "name": "flash_attention", "by_mode": out, "ratios": ratios,
          "bound_f32_cuda_core_ms": f32_bounds,
          "launch_floor_ms": floor_ms,
          "launch_floor": "a one-element add_ timed the same way: the least any call reads",
          "library": "torch.nn.functional.scaled_dot_product_attention on [b, h, t, d] views "
                     "in the inputs' dtype (the normalized output; for flash_partial the fold "
                     "from the empty state normalized), warm",
          "bound": "max(bytes / 3.35 TB/s, 3 x 4bht^2d / 495 TFLOP/s TF32); "
                   "bf16: max(bytes / 3.35 TB/s, 4bht^2d / 989 TFLOP/s)",
          "library_backends": library_backends})
    return out


def shard_ring(torch, fa, q, k, v, num_seq: int, fold):
    """The ring over ``num_seq`` token shards of one sequence in this
    process: shard s folds its own k/v block, then the block of shard s - i
    at hop i, as the ring passes them (``parallel/sp.py``); the shards'
    outputs in order.  ``fold(m, l, a, q, k, v)`` is the kernel
    (``flash_block_update``) or a plain version.  Returns the output and
    the state buffers of every fold, by shard."""
    b, t, h, d = q.shape
    tl = t // num_seq
    block = lambda x, j: x[:, j * tl:(j + 1) * tl]  # noqa: E731
    outs, states = [], []
    for s in range(num_seq):
        m, l, a = fa.flash_ring_state(b, h, tl, d, q.device)
        seen = []
        for hop in range(num_seq):
            j = (s - hop) % num_seq
            m, l, a = fold(m, l, a, block(q, s), block(k, j), block(v, j))
            seen.append((m, l, a))
        outs.append(fa.flash_ring_finalize(m, l, a, q.dtype))
        states.append(seen)
    return torch.cat(outs, dim=1), states


def ring_hops_phase(torch, np) -> dict:
    """(a) Row 5 with real hops, in one process: the ring over S shards
    (:func:`shard_ring`) with every fold in the kernel, in f32 and bf16,
    without autograd (the state updated in place from hop to hop) and with
    it (new state a hop; q/k/v gradients through the kernel's recompute),
    held to the plain ring (the same folds in the plain version) and to
    row 4 on the whole sequence at the flash gates; f32 gradients to the
    plain ring's at the gradient gate of tests/test_flash.py.  Then the
    kernel's time per hop at each shard shape beside its bound, its plain
    version and SDPA on the same block."""
    import torch.nn.functional as F

    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa

    plain_fold = lambda m, l, a, q, k, v: tuple(fa.flash_partial_reference(m, l, a, q, k, v))  # noqa: E731
    twin_fold = lambda m, l, a, q, k, v: tuple(fa.partial_twin(m, l, a, q, k, v))  # noqa: E731
    kernel_fold = lambda m, l, a, q, k, v: tuple(fa.flash_block_update(m, l, a, q, k, v))  # noqa: E731
    report, per_hop = {}, {}
    before = dict(fa.LAUNCHES)
    worst = 0.0
    for i, (num_seq, shape) in enumerate(VIT_RING_CASES):
        b, t, h, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            where = f"S={num_seq} {'bf16 ' if bf16 else ''}{'x'.join(map(str, shape))}"
            out_gate = (dict(rtol=FLASH_BF16_RTOL, atol=FLASH_BF16_ATOL) if bf16
                        else dict(rtol=FLASH_RTOL, atol=FLASH_ATOL))
            q, k, v = flash_inputs(torch, np, shape, 2000 + i, dtype=dtype)
            errs = {}
            with torch.no_grad():
                got, states = shard_ring(torch, fa, q, k, v, num_seq, kernel_fold)
                want, _ = shard_ring(torch, fa, q, k, v, num_seq, plain_fold)
                whole, _ = fa.flash_fwd(q, k, v)
            torch.cuda.synchronize()
            in_place = all(all(x is y for x, y in zip(seen[0], hop)) for seen in states
                           for hop in seen)
            check(in_place, f"ring {where}: the no-grad state was not updated in place")
            errs["no_grad_vs_plain_ring"], _ = flash_close(torch, got, want,
                                                           f"ring {where} vs plain", **out_gate)
            errs["no_grad_vs_whole_fwd"], _ = flash_close(torch, got, whole,
                                                          f"ring {where} vs row 4", **out_gate)
            qkv = q._base.detach().view(b, t, h, 3, d).clone().requires_grad_()
            qg, kg, vg = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
            got_g, _ = shard_ring(torch, fa, qg, kg, vg, num_seq, kernel_fold)
            cot = torch.from_numpy(np.random.RandomState(i).randn(*shape).astype(np.float32))
            cot = cot.to("cuda", dtype)
            (got_g.float() * cot.float()).sum().backward()
            errs["grad_out_vs_plain_ring"], _ = flash_close(torch, got_g.detach(), want,
                                                            f"ring {where} (grad) vs plain",
                                                            **out_gate)
            if not bf16 and t <= 1024:
                ref = q._base.detach().view(b, t, h, 3, d).clone().requires_grad_()
                want_g, _ = shard_ring(torch, fa, ref[..., 0, :], ref[..., 1, :],
                                       ref[..., 2, :], num_seq, twin_fold)
                (want_g * cot).sum().backward()
                errs["grad_qkv_vs_plain_ring"], _ = flash_close(
                    torch, qkv.grad, ref.grad, f"ring {where} q/k/v gradients", rtol=1e-4,
                    atol=1e-5)
            worst = max([worst, *errs.values()])
            report[where] = errs
            # one hop: a k/v block folded into a shard's state
            tl = t // num_seq
            hop = tuple(x[:, :tl] for x in (q, k, v))
            m, l, a = fa.flash_ring_state(b, h, tl, d, "cuda")
            bound_ms, bound_by, _ = flash_bound("flash_partial", (b, tl, h, d), bf16)
            qt, kt, vt = (x.transpose(1, 2) for x in hop)
            per_hop[where] = {
                "shard": [b, tl, h, d], "hops_per_call": num_seq,
                "ms": median_ms(torch, lambda: fa.flash_partial(m, l, a, *hop)),
                "plain_ms": median_ms(torch, lambda: fa.flash_partial_reference(m, l, a, *hop)),
                "library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                "bound_ms": bound_ms, "bound_by": bound_by}
    launches = {k: fa.LAUNCHES[k] - before[k] for k in before}
    emit({"phase": "vit_parallel", "part": "a_ring_hops_one_process",
          "gates": {"out": "flash gates (f32 rtol 1e-5 / atol 1e-6; bf16 2^-7 / 2^-8)",
                    "f32 q/k/v gradients": "rtol 1e-4 / atol 1e-5"},
          "max_abs_err": report, "per_hop": per_hop, "comparison_launches": launches})
    return {"max_abs_err": worst, "per_hop": per_hop}


def vit_leg_launches(flags: list[str], ranks: int, steps: int) -> tuple[dict, str, int]:
    """The flash launches ``ranks`` ranks' ``steps`` train steps of a leg
    make, and the formula: row 5 S times an attention call on the ring
    (the resident block and S - 1 hops; the backward recomputes through
    plain torch and launches none), row 4 once a call otherwise (none
    without --flash).  Also the host-staged transfers a rank makes over
    gloo: on the ring S - 1 passes an attention call forward and as many
    backward; under --pp (2 stages) one boundary send a microbatch
    (activations forward from stage 0, cotangents back from stage 1)."""
    from pytorch_mnist_ddp_tpu_torch import vit_mnist
    from pytorch_mnist_ddp_tpu_torch.models.vit import ViTConfig

    args = vit_mnist.build_parser().parse_args(flags)
    sp_on, tp_on = vit_mnist.resolve_mode_flags(args)
    ring = sp_on and args.sp_impl == "ring"
    depth = ViTConfig().depth
    n = ranks * steps * depth * (args.sp if ring else 1) * args.flash
    mode = "flash_partial" if ring else "flash_fwd"
    formula = (f"{ranks} ranks x {steps} steps x depth {depth}"
               + (f" x S={args.sp} (fwd only)" if ring else " (fwd only)")
               + ("" if args.flash else ", no --flash: 0"))
    passes = steps * depth * 2 * (args.sp - 1) if ring else 0
    if args.pp:  # 2 stages: each rank sends one way, a microbatch at a time
        passes = steps * args.pp_microbatches
    return {"flash_fwd": 0, "flash_partial": 0, mode: n}, formula, passes


def vit_par_batches(np, workdir: str) -> str:
    """VIT_PAR_STEPS fixed batches of the CLI's 64 rows, in a file the
    rank processes read."""
    import os

    from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
    from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize

    images, labels = synthetic_mnist("train", VIT_PAR_STEPS * 64)
    path = os.path.join(workdir, "vit_batches.npz")
    np.savez(path, xs=normalize(images).reshape(VIT_PAR_STEPS, 64, 28, 28, 1),
             ys=labels.astype(np.int64).reshape(VIT_PAR_STEPS, 64))
    return path


def vit_idx_root(np, workdir: str, train_rows: int = VIT_PAR_STEPS * 64,
                 name: str = "vit_idx") -> str:
    """A data root of MNIST IDX files on which one epoch of vit_mnist is
    VIT_PAR_STEPS steps (by default): that many batches of 64 training
    rows (``train_rows``) and 1000 test rows of the synthetic set."""
    import os
    import struct

    from pytorch_mnist_ddp_tpu_torch.data.mnist import _FILES, synthetic_mnist

    root = os.path.join(workdir, name)
    os.makedirs(root, exist_ok=True)
    for split, n in (("train", train_rows), ("test", 1000)):
        images, labels = synthetic_mnist(split, n)
        with open(os.path.join(root, _FILES[(split, "images")]), "wb") as f:
            f.write(struct.pack(">iiii", 2051, n, 28, 28) + images.astype(np.uint8).tobytes())
        with open(os.path.join(root, _FILES[(split, "labels")]), "wb") as f:
            f.write(struct.pack(">ii", 2049, n) + labels.astype(np.uint8).tobytes())
    return root


def vit_cli_against_fit(torch, np, workdir: str, env: dict) -> dict:
    """(b)'s --sp 1 --allow-degree-1 --flash leg as a user runs it, the
    launcher starting vit_mnist's CLI in an NCCL world of one, against
    the same flags through vit_mnist.fit() in this process without a
    launcher: one epoch of VIT_PAR_STEPS steps on an IDX data root (fit's
    loader, run_epochs and --save-model), the logged lines and the saved
    params archive equal."""
    import os

    from pytorch_mnist_ddp_tpu_torch import vit_mnist

    root = vit_idx_root(np, workdir)
    flags = [*VIT_PAR_LEGS["sp1_flash"], "--epochs", "1", "--log-interval", "1",
             "--save-model", "--data-root", root]
    args = vit_mnist.build_parser().parse_args(flags)
    fit_path = os.path.join(workdir, "vit_fit.npz")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        vit_mnist.fit(args, vit_mnist.resolve_mode_flags(args), "cuda", save_path=fit_path)
    cli_dir = os.path.join(workdir, "vit_cli")
    os.makedirs(cli_dir, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         "--nproc_per_node=1", f"--master_port={free_port()}", "-m",
         "pytorch_mnist_ddp_tpu_torch.vit_mnist", *flags],
        cwd=cli_dir, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"vit CLI launcher leg exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")

    def logged(text):
        return [ln for ln in text.splitlines() if ln.startswith(("Train Epoch", "Test set"))]

    with np.load(fit_path) as want, np.load(os.path.join(cli_dir, vit_mnist.SAVE_PATH)) as got:
        archive_equal = (list(got.keys()) == list(want.keys())
                         and all(got[k].tobytes() == want[k].tobytes() for k in want.keys()))
    lines = logged(proc.stdout)
    return {"ok": {"logged_lines_equal": lines == logged(out.getvalue()),
                   "saved_archive_equal": archive_equal,
                   "steps": sum(ln.startswith("Train Epoch") for ln in lines) == VIT_PAR_STEPS},
            "lines": len(lines), "cli_wall_seconds": cli_s}


def grouped_moe_step(cfg, groups: int):
    """The MoE ViT's train step in one process with its tokens routed in
    ``groups`` row blocks of the batch, each a routing group of its own
    (the expert-parallel ranks' groups), the blocks' balance losses
    averaged: what ``groups`` EP ranks compute, without a collective."""
    import torch

    from pytorch_mnist_ddp_tpu_torch.models.moe import MoeOut, moe_mlp_dense
    from pytorch_mnist_ddp_tpu_torch.models.vit import vit_moe_forward
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_forward_train_step
    from pytorch_mnist_ddp_tpu_torch.parallel.ep import AUX_LOSS_WEIGHT

    def grouped(moe, h):
        outs = [moe_mlp_dense(moe, part, cfg.num_experts, cfg.capacity_factor)
                for part in h.chunk(groups)]
        size = torch.full((), groups, dtype=torch.float32, device=h.device)
        return MoeOut(torch.cat([o.y for o in outs]),
                      torch.stack([o.aux_loss for o in outs]).sum() / size)

    def forward(m, x):
        log_probs, aux = vit_moe_forward(m, x, moe_fn=grouped)
        return log_probs, AUX_LOSS_WEIGHT * aux

    return make_forward_train_step(forward)


def run_vit_legs(world, legs, batches: str, groups: int = 0) -> dict:
    """Each leg of ``legs`` (VIT_PAR_LEGS) on this rank: vit_mnist's
    builder (the model from --seed, sharded under --tp and --experts; the
    branch's step), VIT_PAR_STEPS steps on this rank's data shard of the
    fixed batches at lr 1.0; the losses, a digest of the replicated leaves
    after every step, the final state (gathered under --tp and
    --experts), and the flash launches and host-staged transfers of the
    leg.  With ``groups`` an --experts leg takes :func:`grouped_moe_step`
    instead (a reference, in one process)."""
    import hashlib

    import numpy as np
    import torch

    from pytorch_mnist_ddp_tpu_torch import vit_mnist
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.parallel import ep, mesh, tp_vit
    from pytorch_mnist_ddp_tpu_torch.utils.convert import ep_split_dim, tp_split_dim

    data = np.load(batches)
    out = {}
    for leg in legs:
        args = vit_mnist.build_parser().parse_args(VIT_PAR_LEGS[leg])
        modes = vit_mnist.resolve_mode_flags(args)
        device = torch.device("cuda", torch.cuda.current_device())
        model, state, step, _, grid = vit_mnist.build(args, device, modes, world)
        if groups and args.experts:
            step = grouped_moe_step(model.cfg, groups)
        rows = data["xs"].shape[1] // grid.num_data
        cut = slice(grid.coords[0] * rows, (grid.coords[0] + 1) * rows)
        xs = torch.from_numpy(data["xs"][:, cut]).to(device)
        ys = torch.from_numpy(data["ys"][:, cut]).to(device)
        w = torch.ones(rows, device=device)
        before, staged = dict(fa.LAUNCHES), mesh.STAGED["calls"]
        losses, digests = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(VIT_PAR_STEPS):
            losses.append(step(model, state, xs[i], ys[i], w, 1.0))
            h = hashlib.sha256()
            for name, p in model.named_parameters():
                if tp_split_dim(name) is None and ep_split_dim(name) is None:
                    h.update(p.detach().cpu().numpy().tobytes())
            digests.append(h.hexdigest())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if modes[1]:
            full = tp_vit.gather_vit_tp_state(model, grid.model)
        elif args.experts and not groups:
            full = ep.gather_ep_state(model, grid.data)
        else:
            full = model.state_dict()
        out[leg] = {"losses": torch.stack(losses).cpu(), "digests": digests,
                    "state": {k: v.detach().cpu() for k, v in full.items()},
                    "launches": {k: fa.LAUNCHES[k] - before[k] for k in before},
                    "staged_ring_passes": mesh.STAGED["calls"] - staged,
                    "coords": grid.coords, "shape": grid.shape, "seconds": seconds}
    return out


def vit_rank_program(argv: list[str]) -> int:
    """``chip_smoke.py --vit-rank OUT BATCHES LEG...``: the rank program the
    launcher runs in the vit_parallel phase's NCCL world: the world from
    the launcher's environment (NCCL on cuda:LOCAL_RANK), fit()'s
    switches, the legs; writes the results and the backend to OUT."""
    import os

    import torch
    import torch.distributed as dist

    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import destroy_distributed, form_world

    out, batches, legs = argv[0], argv[1], argv[2:]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world = form_world()
    # every collective the legs call (a group of one calls none)
    calls: dict[str, int] = {}
    for name in ("all_reduce", "all_gather", "all_to_all_single", "reduce_scatter_tensor",
                 "all_gather_into_tensor", "batch_isend_irecv", "broadcast"):
        def counted(*a, _fn=getattr(dist, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        setattr(dist, name, counted)
    try:
        result = {"backend": dist.get_backend(), "legs": run_vit_legs(world, legs, batches),
                  "collectives": calls}
    finally:
        destroy_distributed()
    torch.save(result, f"{out}.rank{os.environ['RANK']}")
    return 0


def vit_gloo_rank(rank: int, world_size: int, init_file: str, workdir: str, batches: str,
                  legs: tuple, epoch: bool) -> None:
    """Rank ``rank`` of ``world_size`` gloo ranks sharing cuda:0: the legs,
    then with ``epoch`` one epoch of VIT_PAR_EPOCH through vit_mnist.fit
    (rank 0's lines kept; the host time of every ring pass recorded)."""
    import os

    import torch
    import torch.distributed as dist

    from pytorch_mnist_ddp_tpu_torch import vit_mnist
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.parallel import mesh
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import destroy_distributed, form_world

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK="0")
    world = form_world(f"file://{init_file}", rdzv_timeout_s=120, backend="gloo")
    result = {"backend": dist.get_backend(), "device": torch.cuda.current_device()}
    try:
        result["legs"] = run_vit_legs(world, legs, batches)
        if epoch:
            exchange, pass_s = mesh._exchange, []

            def timed_exchange(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return exchange(*a, **kw)
                finally:
                    pass_s.append(time.perf_counter() - t0)

            mesh._exchange = timed_exchange
            args = vit_mnist.build_parser().parse_args(
                [*VIT_PAR_EPOCH, "--data-root", os.path.join(workdir, "vit_cut_idx")])
            timings: dict = {}
            before, staged = dict(fa.LAUNCHES), mesh.STAGED["calls"]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                vit_mnist.fit(args, vit_mnist.resolve_mode_flags(args), None,
                              timings=timings, world=world)
            result["epoch"] = {
                "lines": [ln for ln in out.getvalue().splitlines()
                          if ln and not ln.startswith("MNIST IDX")],
                "timings": timings,
                "launches": {k: fa.LAUNCHES[k] - before[k] for k in before},
                "staged_ring_passes": mesh.STAGED["calls"] - staged,
                "ring_passes": len(pass_s), "ring_pass_us_median": 1e6 * statistics.median(pass_s),
                "ring_pass_us_mean": 1e6 * statistics.fmean(pass_s)}
    finally:
        destroy_distributed()
    torch.save(result, os.path.join(workdir, f"vit_gloo{world_size}_rank{rank}.pt"))


def gloo_world(ranks: int, workdir: str, batches: str, legs: tuple, epoch: bool,
               timeout: float = 600.0) -> tuple[list, float]:
    """``ranks`` spawned gloo ranks sharing cuda:0 (:func:`vit_gloo_rank`);
    their results in rank order and the wall seconds."""
    import multiprocessing
    import os

    import torch

    ctx = multiprocessing.get_context("spawn")
    init_file = os.path.join(workdir, f"vit_gloo{ranks}_rdzv")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=vit_gloo_rank,
                         args=(r, ranks, init_file, workdir, batches, legs, epoch))
             for r in range(ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(timeout=10)
    wall = time.perf_counter() - t0
    check(not alive and [p.exitcode for p in procs] == [0] * ranks,
          f"{ranks} gloo ranks exited {[p.exitcode for p in procs]}")
    return [torch.load(os.path.join(workdir, f"vit_gloo{ranks}_rank{r}.pt"), weights_only=False)
            for r in range(ranks)], wall


def hold_leg(torch, leg: str, ranks: list, refs: dict, ref_leg: str | None = None) -> dict:
    """One leg's ranks against each other (the replicated leaves after
    every step, the losses of the ranks of one data shard, the final
    state) and against ``refs[ref_leg]``
    (by default the single-device --flash run of its dtype), and its
    launches against the formula."""
    got = [r["legs"][leg] for r in ranks]
    bf16 = leg.startswith("bf16_")
    ref = refs[ref_leg or ("bf16_flash" if bf16 else "flash")]
    a = got[0]
    want, formula, passes = vit_leg_launches(VIT_PAR_LEGS[leg], len(ranks), VIT_PAR_STEPS)
    # gloo's send and receive stage every ring pass of a CUDA tensor
    staged = passes if ranks[0]["backend"] == "gloo" else 0
    launches = {k: sum(g["launches"][k] for g in got) for k in want}
    # each data shard's loss (its first rank's); the mean over the shards,
    # equal rows each, is the loss of the reference's global batch
    shards = {}
    for g in got:
        shards.setdefault(g["coords"][0], g["losses"])
    losses = torch.stack([shards[d] for d in sorted(shards)]).mean(0)
    loss_diff = float((losses - ref["losses"]).abs().max())
    param_diff = max(float((a["state"][k] - ref["state"][k]).abs().max()) for k in ref["state"])
    if bf16:
        within = loss_diff <= VIT_BF16_STEP_ATOL and param_diff <= VIT_BF16_STEP_ATOL
    else:
        within = (torch.allclose(losses, ref["losses"], rtol=VIT_PAR_LOSS_RTOL,
                                 atol=VIT_PAR_LOSS_ATOL) and param_diff <= VIT_PAR_PARAM_ATOL)
    ok = {"replicated_leaves_equal_every_step": all(g["digests"] == a["digests"] for g in got),
          "ranks_losses_equal": all(torch.equal(g["losses"], shards[g["coords"][0]])
                                    for g in got),
          "final_state_equal": all(all(torch.equal(g["state"][k], a["state"][k])
                                       for k in a["state"]) for g in got),
          "vs_single_device": within, "launches": launches == want,
          "staged_ring_passes": all(g["staged_ring_passes"] == staged for g in got),
          "finite": bool(torch.isfinite(a["losses"]).all())}
    return {"grid": list(a["shape"]), "ranks": len(ranks), "ok": ok,
            "held_to": ref_leg or ("bf16_flash" if bf16 else "flash"),
            "max_abs_loss_diff": loss_diff, "max_abs_param_diff": param_diff,
            "launches": launches, "launch_formula": formula,
            "staged_ring_passes_per_rank": [g["staged_ring_passes"] for g in got],
            "staged_ring_passes_formula": f"{VIT_PAR_STEPS} steps x depth 2 x (fwd + bwd) x "
                                          f"(S - 1) on the ring over gloo; --pp: "
                                          f"{VIT_PAR_STEPS} steps x 2 microbatches; else 0",
            "ms_per_step_rank0": 1e3 * a["seconds"] / VIT_PAR_STEPS,
            "first_last_loss": [float(losses[0]), float(losses[-1])]}


def vit_parallel_phase(torch, np, workdir: str, sp1_cut: dict) -> tuple[dict, dict]:
    """(b)-(e) of the vit_parallel phase: the parallel modes' main path;
    (e)'s --sp 2 epoch is held to ``sp1_cut``, vit_train's --sp 1 epoch on
    the same VIT_CUT_ROWS rows, within the f32 trajectory gates.  Returns its flash launches (the ranks' processes') and the launches of
    the references (the single-device steps and the in-process sp1 leg),
    counted apart; the caller zeroes the counters first."""
    import os

    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState

    t_phase = time.perf_counter()
    batches = vit_par_batches(np, workdir)
    # the references, in this process: single device and sp1 without a world
    start = dict(fa.LAUNCHES)
    refs = run_vit_legs(DistState(), ("flash", "bf16_flash", "sp1_flash"), batches)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    # (b) the CLI under the launcher against fit(), whose launches count
    # with the references (the CLI's are in its own process)
    cli = vit_cli_against_fit(torch, np, workdir, env)
    references = {k: fa.LAUNCHES[k] - start[k] for k in start}
    main0 = dict(fa.LAUNCHES)
    legs, launches = {}, {k: 0 for k in fa.LAUNCHES}

    # (b) an NCCL world of one through the launcher, (c) + (e) two gloo
    # ranks sharing the card and (d) four: three worlds of their own
    # processes, started together
    counts = os.path.join(workdir, "vit_counts")
    vit_idx_root(np, workdir, VIT_CUT_ROWS, "vit_cut_idx")  # (e)'s epoch
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         "--nproc_per_node=1", f"--master_port={free_port()}", os.path.abspath(__file__),
         "--vit-rank", counts, batches, *VIT_PAR_NCCL],
        cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with ThreadPoolExecutor(3) as pool:
        nccl_done = pool.submit(waited_process, proc, t0)
        two_done = pool.submit(gloo_world, 2, workdir, batches, VIT_PAR_TWO, epoch=True)
        four_done = pool.submit(gloo_world, 4, workdir, batches, VIT_PAR_FOUR, epoch=False)
        rc, _, err, nccl_s = nccl_done.result()
        (two, two_s), (four, four_s) = two_done.result(), four_done.result()
    check(rc == 0, f"vit launcher leg exited {rc}: {err[-2000:]}")
    nccl = torch.load(counts + ".rank0", weights_only=False)
    check(nccl["backend"] == "nccl", f"vit launcher leg formed {nccl['backend']}")
    for leg in VIT_PAR_NCCL:
        legs[leg] = hold_leg(torch, leg, [nccl], refs)
    alone = refs["sp1_flash"]
    got = nccl["legs"]["sp1_flash"]
    legs["sp1_flash"]["ok"].update(cli_equal_to_fit_without_launcher=all(cli["ok"].values()))
    legs["sp1_flash"]["cli_against_fit"] = cli
    legs["sp1_flash"]["ok"]["equal_to_builder_without_launcher"] = (
        torch.equal(got["losses"], alone["losses"])
        and all(torch.equal(got["state"][k], alone["state"][k]) for k in alone["state"]))

    check(all(r["backend"] == "gloo" and r["device"] == 0 for r in two + four),
          "vit gloo ranks not gloo on cuda:0")
    for leg in VIT_PAR_TWO:
        legs[leg] = hold_leg(torch, leg, two, refs)
    for leg in VIT_PAR_FOUR:
        legs[leg] = hold_leg(torch, leg, four, refs)
    for leg, r in legs.items():
        for k in launches:
            launches[k] += r["launches"][k]

    # (e) one epoch of --sp 2 --flash on the two ranks, VIT_CUT_ROWS rows,
    # held to vit_train's --sp 1 epoch on the same rows (no hop): the
    # logged losses and the test loss within the f32 gates (the test line
    # prints 4 decimals), the test set's correct rows within
    # VIT_CUT_CORRECT_SLACK
    ep = [r["epoch"] for r in two]
    lines = ep[0]["lines"]
    tests = [TEST_LINE.match(ln) for ln in lines if ln.startswith("Test set")]
    train = [TRAIN_LINE.match(ln) for ln in lines if ln.startswith("Train Epoch")]
    check(len(tests) == 1 and all(tests) and all(train), "vit epoch leg: malformed lines")
    check(not any(r["epoch"]["lines"] for r in two[1:]), "vit epoch leg: rank 1 printed")
    timings = ep[0]["timings"]
    steps = sum(timings["epoch_steps"])
    eval_batches = -(-timings["test_size"] // 1000)
    depth = 2
    want_epoch = 2 * depth * 2 * (steps + eval_batches)
    # a rank's ring passes: S - 1 = 1 an attention call, forward and backward
    # in training, forward in eval; every one staged over gloo
    want_passes = depth * (2 * steps + eval_batches)
    epoch_launches = {k: sum(e["launches"][k] for e in ep) for k in fa.LAUNCHES}
    acc1 = timings["epoch1_test_accuracy"]
    for k in launches:
        launches[k] += epoch_launches[k]
    losses = [float(m.group(5)) for m in train]
    test_loss, correct = float(tests[0].group(1)), int(tests[0].group(2))
    ref_correct = round(sp1_cut["test_accuracy_by_epoch"][0] * int(tests[0].group(3)))
    ref_loss = sp1_cut["test_loss_by_epoch"][0]
    held = {"logged_losses": len(losses) == len(sp1_cut["logged_losses"]) and torch.allclose(
                torch.tensor(losses), torch.tensor(sp1_cut["logged_losses"]),
                rtol=VIT_PAR_LOSS_RTOL, atol=VIT_PAR_LOSS_ATOL),
            "test_loss": abs(test_loss - ref_loss)
            <= VIT_PAR_LOSS_RTOL * abs(ref_loss) + VIT_PAR_LOSS_ATOL + 1e-4,
            "test_correct": abs(correct - ref_correct) <= VIT_CUT_CORRECT_SLACK}
    epoch = {"epoch1_test_accuracy": acc1, "steps": steps,
             "held_to_vit_train_sp1_flash": held,
             "sp1_flash_test_accuracy": sp1_cut["test_accuracy_by_epoch"][0],
             "ms_per_step": 1e3 * timings["epoch_train_s"][0] / steps,
             "train_seconds": timings["epoch_train_s"][0],
             "ring_passes_rank0": ep[0]["ring_passes"],
             "host_us_per_ring_pass_median": ep[0]["ring_pass_us_median"],
             "host_us_per_ring_pass_mean": ep[0]["ring_pass_us_mean"],
             "staged_ring_passes_rank0": ep[0]["staged_ring_passes"],
             "staged_ring_passes_formula": f"depth {depth} x (2 x {steps} steps + "
                                           f"{eval_batches} eval batches) a rank",
             "launches": epoch_launches,
             "launch_formula": f"2 ranks x depth {depth} x S=2 x ({steps} steps + "
                               f"{eval_batches} eval batches)",
             "logged_losses": losses}
    local = {k: fa.LAUNCHES[k] - main0[k] for k in main0}
    emit({"phase": "vit_parallel", "part": "b_to_e_worlds",
          "steps": VIT_PAR_STEPS, "f32_gates": {"loss_rtol": VIT_PAR_LOSS_RTOL,
                                                "loss_atol": VIT_PAR_LOSS_ATOL,
                                                "param_atol": VIT_PAR_PARAM_ATOL},
          "bf16_gate_atol": VIT_BF16_STEP_ATOL, "legs": legs, "epoch_sp2_flash_two_gloo": epoch,
          "nccl_launcher_wall_seconds": nccl_s, "gloo2_wall_seconds": two_s,
          "gloo4_wall_seconds": four_s, "seconds": time.perf_counter() - t_phase,
          "launches": launches, "reference_launches": references})
    for leg, r in legs.items():
        check(all(r["ok"].values()), f"vit_parallel {leg}: {r['ok']}")
    check(all(held.values()), f"vit --sp 2 epoch off vit_train's --sp 1 epoch on the same "
          f"rows: {held}; accuracy {acc1}, losses {losses}")
    check(epoch_launches == {"flash_fwd": 0, "flash_partial": want_epoch},
          f"vit epoch leg launches {epoch_launches} != {want_epoch}")
    check(all(e["staged_ring_passes"] == e["ring_passes"] == want_passes for e in ep),
          f"vit epoch leg ring passes {[(e['staged_ring_passes'], e['ring_passes']) for e in ep]}"
          f" != {want_passes}")
    check(local == {k: 0 for k in local}, f"vit_parallel launched {local} in this process")
    return launches, references


def routing_record(torch, cfg, state: dict, ref_state: dict, x, groups: int) -> dict:
    """How the rank-trained MoE ViT (``state``) and its one-process
    reference (``ref_state``) route the rows ``x`` after their steps, each
    on its own tokens, in ``groups`` row blocks: the tokens whose expert
    differs (over both blocks) and the reference's smallest top-1/top-2
    gate probability margin."""
    from pytorch_mnist_ddp_tpu_torch.models.moe import gate_probs, moe_mlp_dense
    from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, vit_moe_forward

    def experts(st):
        model = ViT(cfg).cuda()
        model.load_state_dict({k: v.cuda() for k, v in st.items()})
        chosen, margins = [], []

        def recording(moe, h):
            probs = gate_probs(moe.gate, h.reshape(-1, h.shape[-1]))
            top2 = probs.topk(2, dim=-1).values
            chosen.append(probs.argmax(-1))
            margins.append(top2[:, 0] - top2[:, 1])
            outs = [moe_mlp_dense(moe, part, cfg.num_experts, cfg.capacity_factor)
                    for part in h.chunk(groups)]
            return type(outs[0])(torch.cat([o.y for o in outs]),
                                 torch.stack([o.aux_loss for o in outs]).mean())

        with torch.no_grad():
            vit_moe_forward(model, x, moe_fn=recording)
        return torch.cat(chosen), torch.cat(margins)

    got, _ = experts(state)
    want, margin = experts(ref_state)
    return {"tokens": int(want.numel()), "routing_flips": int((got != want).sum()),
            "min_top1_top2_margin": float(margin.min())}


def vit_family_phase(torch, np, workdir: str) -> tuple[dict, dict]:
    """The vit_family phase: --experts, --zero and --pp.  (a) An NCCL world
    of one through the launcher (this script the rank program): 20 fixed
    steps of --experts 8 --flash, twice, and of --zero --flash, each
    torch.equal to the same steps through vit_mnist's builder without a
    launcher, --zero also to the single-device --flash steps, the MoE
    repeat to the first run, no collective called; (b) two gloo ranks
    sharing the card, 20 steps of --experts 8 --flash (4 experts a rank,
    both all-to-alls real), --zero --flash and --pp, f32 and --bf16; (c)
    four: --experts 8 --flash (2 a rank) and --pp on a 2 x 2 grid (the
    three worlds' processes run at once); each
    leg's replicated leaves bit-equal on every rank after every step and
    held at the trajectory gates to its reference in this process: the
    MoE legs to the same routing groups, --zero to the single-device
    --flash steps, --pp to the single-device plain steps; the MoE legs'
    routing flips and smallest margin recorded; (d) one epoch of
    --experts 8 --flash through vit_mnist.fit on the single device
    (epoch-1 accuracy floor, ms a step, row 4's launches at their
    formula).  Returns the path's flash launches and, apart, those of the
    references."""
    import os

    from pytorch_mnist_ddp_tpu_torch import vit_mnist
    from pytorch_mnist_ddp_tpu_torch.models.vit import ViTConfig
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.parallel import mesh
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState

    t_phase = time.perf_counter()
    batches = vit_par_batches(np, workdir)
    start = dict(fa.LAUNCHES)
    one = DistState()
    refs = run_vit_legs(one, ("experts_flash", "zero_flash", "flash", "plain", "bf16_flash",
                              "bf16_plain"), batches)
    for groups, names in ((2, ("experts_flash", "bf16_experts_flash")), (4, ("experts_flash",))):
        for leg, ref in run_vit_legs(one, names, batches, groups).items():
            refs[f"{leg}@{groups}"] = ref
    references = {k: fa.LAUNCHES[k] - start[k] for k in start}
    main0 = dict(fa.LAUNCHES)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    legs, launches = {}, {k: 0 for k in fa.LAUNCHES}

    # (a) an NCCL world of one through the launcher, (b) two gloo ranks
    # sharing the card and (c) four: three worlds of their own processes,
    # started together, (d) run beside them
    counts = os.path.join(workdir, "fam_counts")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         "--nproc_per_node=1", f"--master_port={free_port()}", os.path.abspath(__file__),
         "--vit-rank", counts, batches, *VIT_FAM_NCCL],
        cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with ThreadPoolExecutor(3) as pool:
        nccl_done = pool.submit(waited_process, proc, t0)
        two_done = pool.submit(gloo_world, 2, workdir, batches, VIT_FAM_TWO, epoch=False)
        four_done = pool.submit(gloo_world, 4, workdir, batches, VIT_FAM_FOUR, epoch=False)
        # (d) one epoch of --experts 8 --flash on the single device, in this
        # process while the worlds' processes run
        args = vit_mnist.build_parser().parse_args(VIT_FAM_EPOCH)
        timings: dict = {}
        before = dict(fa.LAUNCHES)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            vit_mnist.fit(args, vit_mnist.resolve_mode_flags(args), "cuda", timings=timings)
        epoch_launches = {k: fa.LAUNCHES[k] - before[k] for k in before}
        steps = sum(timings["epoch_steps"])
        eval_batches = -(-timings["test_size"] // args.test_batch_size)
        depth = ViTConfig().depth
        want_epoch = depth * (steps + eval_batches)
        rc, _, err, nccl_s = nccl_done.result()
        (two, two_s), (four, four_s) = two_done.result(), four_done.result()
    check(rc == 0, f"vit_family launcher leg exited {rc}: {err[-2000:]}")
    nccl = torch.load(counts + ".rank0", weights_only=False)
    check(nccl["backend"] == "nccl", f"vit_family launcher leg formed {nccl['backend']}")

    def same(a, b):
        return (torch.equal(a["losses"], b["losses"])
                and all(torch.equal(a["state"][k], b["state"][k]) for k in b["state"]))

    got = nccl["legs"]
    for leg, ref_leg in (("experts_flash", "experts_flash"), ("experts_flash_again",
                                                              "experts_flash"),
                         ("zero_flash", "flash")):
        legs[f"nccl1_{leg}"] = hold_leg(torch, leg, [nccl], refs, ref_leg)
    legs["nccl1_experts_flash"]["ok"].update(
        equal_to_builder_without_launcher=same(got["experts_flash"], refs["experts_flash"]),
        repeats_bit_for_bit=same(got["experts_flash_again"], got["experts_flash"]))
    legs["nccl1_zero_flash"]["ok"].update(
        equal_to_builder_without_launcher=same(got["zero_flash"], refs["zero_flash"]),
        equal_to_single_device_flash=same(got["zero_flash"], refs["flash"]))
    legs["nccl1_zero_flash"]["ok"]["no_collective"] = not nccl["collectives"]
    legs["nccl1_zero_flash"]["collectives"] = nccl["collectives"]

    check(all(r["backend"] == "gloo" and r["device"] == 0 for r in two + four),
          "vit_family gloo ranks not gloo on cuda:0")
    data = np.load(batches)
    x0 = torch.from_numpy(data["xs"][0]).cuda()
    for ranks, names in ((two, VIT_FAM_TWO), (four, VIT_FAM_FOUR)):
        for leg in names:
            bf16 = leg.startswith("bf16_")
            ref_leg = (f"{leg}@{len(ranks)}" if "experts" in leg
                       else ("bf16_" if bf16 else "") + ("plain" if leg.endswith("pp")
                                                          else "flash"))
            key = f"gloo{len(ranks)}_{leg}"
            legs[key] = hold_leg(torch, leg, ranks, refs, ref_leg)
            if "experts" in leg:
                legs[key]["routing"] = routing_record(
                    torch, ViTConfig(num_experts=8, bf16=bf16), ranks[0]["legs"][leg]["state"],
                    refs[ref_leg]["state"], x0, len(ranks))
    for r in legs.values():
        for k in launches:
            launches[k] += r["launches"][k]

    for k in launches:
        launches[k] += epoch_launches[k]
    acc1 = timings["epoch1_test_accuracy"]
    epoch = {"epoch1_test_accuracy": acc1, "steps": steps,
             "ms_per_step": 1e3 * timings["epoch_train_s"][0] / steps,
             "train_seconds": timings["epoch_train_s"][0], "launches": epoch_launches,
             "launch_formula": f"depth {depth} x ({steps} steps + {eval_batches} eval batches)",
             "lines": [ln for ln in out.getvalue().splitlines()
                       if ln.startswith("Test set")]}
    local = {k: fa.LAUNCHES[k] - main0[k] - epoch_launches[k] for k in main0}
    emit({"phase": "vit_family", "steps": VIT_PAR_STEPS,
          "f32_gates": {"loss_rtol": VIT_PAR_LOSS_RTOL, "loss_atol": VIT_PAR_LOSS_ATOL,
                        "param_atol": VIT_PAR_PARAM_ATOL},
          "bf16_gate_atol": VIT_BF16_STEP_ATOL, "legs": legs,
          "epoch_experts8_flash_single_device": epoch,
          "staged_sends_total": mesh.STAGED["calls"],
          "nccl_launcher_wall_seconds": nccl_s, "gloo2_wall_seconds": two_s,
          "gloo4_wall_seconds": four_s, "seconds": time.perf_counter() - t_phase,
          "launches": launches, "reference_launches": references})
    for leg, r in legs.items():
        check(all(r["ok"].values()), f"vit_family {leg}: {r['ok']}")
    check(epoch_launches == {"flash_fwd": want_epoch, "flash_partial": 0},
          f"vit_family epoch launches {epoch_launches} != {want_epoch}")
    check(acc1 >= VIT_MOE_EPOCH1_MIN_ACCURACY, f"--experts 8 epoch-1 accuracy {acc1}")
    check(local == {k: 0 for k in local}, f"vit_family launched {local} in this process "
                                          "outside its epoch")
    return launches, references



# -- 19. train_state ---------------------------------------------------------------


def vit_state_fit(flags: list[str], world=None, device: str | None = "cuda") -> dict:
    """vit_mnist.fit() with ``flags`` (in ``world``, else alone): the
    model's state, the per-leaf accumulators (gathered under --zero), the
    step, the printed lines, the timings and the flash launches of the run."""
    from pytorch_mnist_ddp_tpu_torch import vit_mnist
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState
    from pytorch_mnist_ddp_tpu_torch.parallel.zero import is_zero_state, zero_opt_to_per_leaf

    args = vit_mnist.build_parser().parse_args(flags)
    modes = vit_mnist.resolve_mode_flags(args)
    world = world or DistState()
    timings: dict = {}
    before = dict(fa.LAUNCHES)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        model, state = vit_mnist.fit(args, modes, device, timings=timings, world=world)
    wall = time.perf_counter() - t0
    params = dict(model.named_parameters())
    opt = state.opt
    if is_zero_state(opt):
        from pytorch_mnist_ddp_tpu_torch.parallel.mesh import world_group

        opt = zero_opt_to_per_leaf(opt, params, world_group(world))
    return {"params": {k: v.detach().cpu() for k, v in params.items()},
            "opt": [{k: v.cpu() for k, v in tree.items()} for tree in opt], "step": state.step,
            "lines": [ln for ln in out.getvalue().splitlines()
                      if ln.startswith(("Train Epoch", "Test set", "Step stats"))],
            "timings": timings,
            "wall": wall, "launches": {k: fa.LAUNCHES[k] - before[k] for k in before}}


def same_state(torch, a: dict, b: dict) -> bool:
    """Params, per-leaf accumulators and step equal bit for bit."""
    return (a["step"] == b["step"]
            and all(torch.equal(a["params"][k], b["params"][k]) for k in b["params"])
            and all(torch.equal(x[k], y[k]) for x, y in zip(a["opt"], b["opt"]) for k in y))


def same_archive(np, a: str, b: str) -> bool:
    """Two npz archives with the same arrays, byte for byte."""
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].tobytes() == y[k].tobytes() for k in x.files)


def cnn_mp_legs(world, legs: tuple, batches: str) -> dict:
    """Each mnist_ddp --tp 2 / --pp leg of ``legs`` (STATE_MP_LEGS) on this
    rank: the (data, model) grid of the world, the CNN from SEED, TRAIN_STEPS
    fixed steps (dropout off, lr 1.0) on this rank's data shard; the losses,
    a digest of the leaves every rank holds whole after every step, the
    state gathered whole after DDP_GATE_STEPS steps and at the end, and
    the host-staged sends."""
    import hashlib

    import numpy as np
    import torch

    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.ops.adadelta import adadelta_init
    from pytorch_mnist_ddp_tpu_torch.parallel import mesh, pp, tp
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import TrainState

    data = np.load(batches)
    out = {}
    for leg in legs:
        mode, bf16 = STATE_MP_LEGS[leg]
        grid = mesh.make_rank_grid([("model", 2)], world)
        dtype = torch.bfloat16 if bf16 else torch.float32
        net = Net(torch.Generator().manual_seed(SEED)).cuda()
        if mode == "tp":
            tp.shard_state(net, grid.model)
            step = tp.make_tp_train_step(grid, dropout=False, compute_dtype=dtype)
        else:
            step = pp.make_pp_train_step(grid, dropout=False, compute_dtype=dtype)

        def whole():
            full = tp.gather_replicated(net, grid.model) if mode == "tp" else net.state_dict()
            return {k: v.detach().to("cpu", copy=True) for k, v in full.items()}

        state = TrainState(opt=adadelta_init(dict(net.named_parameters())))
        rows = data["xs"].shape[1] // grid.num_data
        cut = slice(grid.coords[0] * rows, (grid.coords[0] + 1) * rows)
        xs = torch.from_numpy(data["xs"][:, cut]).cuda()
        ys = torch.from_numpy(data["ys"][:, cut]).cuda()
        w = torch.ones(rows, device="cuda")
        staged = mesh.STAGED["calls"]
        losses, digests = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            losses.append(step(net, state, xs[i], ys[i], w, 1.0))
            h = hashlib.sha256()
            for name, p in net.named_parameters():
                if tp.split_dim(name) is None:
                    h.update(p.detach().cpu().numpy().tobytes())
            digests.append(h.hexdigest())
            if i + 1 == DDP_GATE_STEPS:
                gate = whole()
        torch.cuda.synchronize()
        out[leg] = {"losses": torch.stack(losses).float().cpu(), "digests": digests,
                    "gate_state": gate, "state": whole(), "coords": grid.coords,
                    "shape": grid.shape, "staged": mesh.STAGED["calls"] - staged,
                    "seconds": time.perf_counter() - t0}
    return out


def cnn_reshard_ranks(world, root: str, archive: str) -> dict:
    """mnist_ddp's data-parallel --pallas-opt steps (dropout off) over one
    epoch of the IDX set at ``root``, STATE_RANK_BATCH rows a rank; rank 0
    writes a mid-epoch archive with the JAX package's extras before batch
    STATE_CURSOR.  Returns this rank's losses, the final state and the
    adadelta launches."""
    import torch

    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state, make_train_step
    from pytorch_mnist_ddp_tpu_torch.trainer import make_loaders
    from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import save_train_state
    from pytorch_mnist_ddp_tpu_torch.utils.rng import split_streams

    args = build_parser().parse_args(["--batch-size", str(STATE_RANK_BATCH), "--pallas-opt",
                                      "--data-root", root])
    net = Net(torch.Generator().manual_seed(split_streams(args.seed)["init"])).cuda()
    state = make_train_state(net, use_pallas=True)
    step = make_train_step(dropout=False, use_pallas=True, world=world)
    loader, _ = make_loaders(args, torch.device("cuda"), dist=world)
    before = dict(af.LAUNCHES)
    losses = []
    for b, (x, y, w) in enumerate(loader.epoch(1)):
        if b == STATE_CURSOR and world.is_chief:
            extras = {"epoch_in_progress": 1, "batch_cursor": b, "seed": args.seed,
                      "global_batch": loader.global_batch, "world_size": world.world_size,
                      "steps_total": state.step, "samples_total": state.step * loader.global_batch}
            save_train_state(dict(net.named_parameters()), state.opt, state.step, archive,
                             epoch=0, extras=extras)
        losses.append(step(net, state, x, y, w, args.lr))
    return {"losses": torch.stack(losses).cpu(), "step": state.step,
            "state": {k: v.detach().cpu() for k, v in net.state_dict().items()},
            "launches": {k: af.LAUNCHES[k] - before[k] for k in before}}


def cnn_tp_save(world, root: str, path: str) -> dict:
    """mnist_ddp --tp 2 --save-model (the trainer's body, dropout on) for
    one epoch of the IDX set at ``root``: rank 0's lines and the model
    gathered whole here (collective)."""
    import torch

    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
    from pytorch_mnist_ddp_tpu_torch.parallel import mesh, tp
    from pytorch_mnist_ddp_tpu_torch.trainer import _fit

    args = build_parser().parse_args(["--tp", "2", "--epochs", "1", "--save-model",
                                      "--data-root", root])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        net, state = _fit(args, None, path, None, world)
    full = tp.gather_replicated(net, mesh.make_rank_grid([("model", 2)], world).model)
    return {"lines": [ln for ln in out.getvalue().splitlines() if ln], "step": state.step,
            "state": {k: v.detach().cpu() for k, v in full.items()}}


def state_gloo_rank(rank: int, world_size: int, init_file: str, workdir: str,
                    jobs: dict) -> None:
    """Rank ``rank`` of ``world_size`` gloo ranks sharing cuda:0 in the
    train_state phase: ``jobs`` ``{"legs": (...), "batches": path}``, and
    with two ranks also ``"reshard"`` and ``"tp_save"`` (an IDX root and
    the file each writes)."""
    import os

    import torch

    from pytorch_mnist_ddp_tpu_torch.parallel import mesh
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import destroy_distributed, form_world

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK="0")
    world = form_world(f"file://{init_file}", rdzv_timeout_s=120, backend="gloo")
    result = {"backend": torch.distributed.get_backend()}
    try:
        if "reshard" in jobs:
            result["reshard"] = cnn_reshard_ranks(world, *jobs["reshard"])
        result["legs"] = cnn_mp_legs(world, jobs["legs"], jobs["batches"])
        if "tp_save" in jobs:
            result["tp_save"] = cnn_tp_save(world, *jobs["tp_save"])
        result["staged_total"] = mesh.STAGED["calls"]
    finally:
        destroy_distributed()
    torch.save(result, os.path.join(workdir, f"state_gloo{world_size}_rank{rank}.pt"))


def state_gloo_world(ranks: int, workdir: str, jobs: dict,
                     timeout: float = 600.0) -> tuple[list, float]:
    """``ranks`` spawned gloo ranks sharing cuda:0 (:func:`state_gloo_rank`);
    their results in rank order and the wall seconds."""
    import multiprocessing
    import os

    import torch

    ctx = multiprocessing.get_context("spawn")
    init_file = os.path.join(workdir, f"state_gloo{ranks}_rdzv")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=state_gloo_rank, args=(r, ranks, init_file, workdir, jobs))
             for r in range(ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(timeout=10)
    wall = time.perf_counter() - t0
    check(not alive and [p.exitcode for p in procs] == [0] * ranks,
          f"train_state: {ranks} gloo ranks exited {[p.exitcode for p in procs]}")
    return [torch.load(os.path.join(workdir, f"state_gloo{ranks}_rank{r}.pt"),
                       weights_only=False) for r in range(ranks)], wall


def state_rank_program(argv: list[str]) -> int:
    """``chip_smoke.py --state-rank OUT SPEC``: the rank program of the
    train_state phase's NCCL world of one (the launcher's environment).
    SPEC (JSON) holds ``vit``, vit_mnist flag lists each run through
    vit_mnist.fit() in this world, and ``reshard``, the mnist_ddp flags of
    the --resume-reshard run (the trainer's body, dropout off as on the
    two ranks that saved its archive); writes each run's results, the
    backend and the launches to OUT."""
    import functools
    import os

    import torch
    import torch.distributed as dist

    from pytorch_mnist_ddp_tpu_torch import trainer
    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_step
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import destroy_distributed, form_world

    out, spec = argv[0], json.load(open(argv[1]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world = form_world()
    result = {"backend": dist.get_backend(), "vit": []}
    try:
        for flags in spec["vit"]:
            result["vit"].append(vit_state_fit(flags, world, None))
        trainer.make_train_step = functools.partial(make_train_step, dropout=False)
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            net, state = trainer._fit(build_parser().parse_args(spec["reshard"]), None, None,
                                      None, world)
        result["reshard"] = {"lines": lines.getvalue().splitlines(), "step": state.step,
                             "state": {k: v.detach().cpu() for k, v in net.state_dict().items()}}
    finally:
        destroy_distributed()
    result["launches"] = {**fa.LAUNCHES, **af.LAUNCHES}
    torch.save(result, f"{out}.rank{os.environ['RANK']}")
    return 0


def cnn_dp_reference(torch, np, batches: str, bf16: bool) -> dict:
    """The one-process data-parallel steps the --tp/--pp legs are held to:
    the CNN from SEED, TRAIN_STEPS steps on the whole fixed batches,
    dropout off, plain Adadelta (no kernel)."""
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state, make_train_step

    data = np.load(batches)
    xs, ys = (torch.from_numpy(data[k]).cuda() for k in ("xs", "ys"))
    w = torch.ones(xs.shape[1], device="cuda")
    net = Net(torch.Generator().manual_seed(SEED)).cuda()
    state = make_train_state(net)
    step = make_train_step(dropout=False,
                           compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    losses = []
    for i in range(TRAIN_STEPS):
        losses.append(step(net, state, xs[i], ys[i], w, 1.0))
        if i + 1 == DDP_GATE_STEPS:
            gate = {k: v.detach().to("cpu", copy=True) for k, v in net.state_dict().items()}
    return {"losses": torch.stack(losses).cpu(), "gate_state": gate,
            "state": {k: v.detach().cpu() for k, v in net.state_dict().items()}}


def hold_mp_leg(torch, leg: str, ranks: list, ref: dict) -> dict:
    """One --tp/--pp leg's ranks against each other and against the
    one-process reference of its dtype: the losses of the first
    DDP_GATE_STEPS steps and the state after them within the gates (f32:
    the trajectory gates; bf16: STATE_BF16_ATOL), the rest recorded."""
    got = [r["legs"][leg] for r in ranks]
    a = got[0]
    mode, bf16 = STATE_MP_LEGS[leg]
    shards = {}
    for g in got:
        shards.setdefault(g["coords"][0], g["losses"])
    losses = torch.stack([shards[d] for d in sorted(shards)]).mean(0)
    ref_losses = ref["losses"].float()
    k = DDP_GATE_STEPS
    gate_param = max(float((a["gate_state"][n] - ref["gate_state"][n]).abs().max())
                     for n in ref["gate_state"])
    gate_loss = float((losses[:k] - ref_losses[:k]).abs().max())
    if bf16:
        within = gate_loss <= STATE_BF16_ATOL and gate_param <= STATE_BF16_ATOL
    else:
        within = (torch.allclose(losses[:k], ref_losses[:k], rtol=DDP_LOSS_RTOL,
                                 atol=DDP_LOSS_ATOL) and gate_param <= DDP_PARAM_ATOL)
    staged = TRAIN_STEPS * 2 if mode == "pp" else 0  # 2 microbatches a step, one way a rank
    ok = {"replicated_leaves_equal_every_step": all(g["digests"] == a["digests"] for g in got),
          "final_state_equal": all(all(torch.equal(g["state"][n], a["state"][n])
                                       for n in a["state"]) for g in got),
          "vs_one_process_dp": within, "staged_sends": all(g["staged"] == staged for g in got),
          "finite": bool(torch.isfinite(losses).all())}
    return {"grid": list(a["shape"]), "ranks": len(ranks), "ok": ok,
            "gate_steps": k, "gate_max_abs_loss_diff": gate_loss,
            "gate_max_abs_param_diff": gate_param,
            f"max_abs_loss_diff_{TRAIN_STEPS}_steps": float((losses - ref_losses).abs().max()),
            f"max_abs_param_diff_{TRAIN_STEPS}_steps": max(
                float((a["state"][n] - ref["state"][n]).abs().max()) for n in ref["state"]),
            "staged_sends_per_rank": [g["staged"] for g in got],
            "host_ms_per_step_rank0": 1e3 * a["seconds"] / TRAIN_STEPS}


def trace_kernels(json_path: str, name: str) -> dict:
    """The kernel events of a torch.profiler Chrome trace whose name holds
    ``name``: their count and the trace's size."""
    import os

    with open(json_path) as f:
        events = json.load(f)["traceEvents"]
    hits = [e for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]
    return {"bytes": os.path.getsize(json_path), "events": len(events),
            "kernel_events": sum(e.get("cat") == "kernel" for e in events),
            f"{name}_events": len(hits)}


def profiled_epoch(run, flags: list[str], prof_dir: str, kernel: str, launches_key: str) -> dict:
    """One epoch of ``run`` (fit_run or vit_state_fit) with ``flags`` plus
    --step-stats, without and then with --profile into ``prof_dir``: the
    step-stats lines, wall and epoch seconds of both, and what the trace
    holds of ``kernel``."""
    import glob

    plain = run([*flags, "--step-stats"])
    traced = run([*flags, "--step-stats", "--profile", prof_dir])
    files = sorted(glob.glob(f"{prof_dir}/*.pt.trace.json"))
    check(len(files) == 1, f"--profile wrote {files}")
    found = trace_kernels(files[0], kernel)
    steps = traced["timings"]["epoch_steps"][0]
    stats = [ln for ln in traced["lines"] if ln.startswith("Step stats epoch")]
    ok = {"one_stats_line": len(stats) == 1 and stats[0].startswith(
              f"Step stats epoch 1: {steps} steps,"),
          "trace_names_the_kernel": found[f"{kernel}_events"] == traced["launches"][launches_key]
          > 0}
    return {"ok": ok, "steps": steps, "stats_line": stats, "trace": found,
            "launches": traced["launches"][launches_key],
            "epoch_train_s": {"unprofiled": plain["timings"]["epoch_train_s"][0],
                              "profiled": traced["timings"]["epoch_train_s"][0]},
            "wall_s": {"unprofiled": plain["wall"], "profiled": traced["wall"]},
            "runs": (plain, traced)}


def train_state_phase(torch, np, workdir: str) -> tuple[dict, dict]:
    """The train_state phase (module docstring, 19).  Returns the path's
    kernel launches (this process's and the ranks') and, apart, those of
    the references it is held to; the caller zeroes the counters first."""
    import os

    from pytorch_mnist_ddp_tpu_torch.models.vit import ViTConfig
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import load_train_state_full

    t_phase = time.perf_counter()
    root = vit_idx_root(np, workdir)
    batches = vit_par_batches(np, workdir)
    at = functools.partial(os.path.join, workdir)
    counts = lambda: {**fa.LAUNCHES, **af.LAUNCHES}  # noqa: E731
    refs0 = counts()
    references = {k: 0 for k in refs0}

    def as_reference(before):
        for k, v in counts().items():
            references[k] += v - before[k]

    record, ok = {}, {}
    depth, epoch_calls = ViTConfig().depth, VIT_PAR_STEPS + 1  # + 1 eval batch of 1000
    data = ["--data-root", root]

    # (a) the ViT in this process: 1 epoch + --save-state, 1 + --resume-state
    for leg, flags in (("flash", ["--flash"]),
                       ("sp1_flash", ["--sp", "1", "--allow-degree-1", "--flash"])):
        before = counts()
        full = vit_state_fit([*flags, *data, "--epochs", "2", "--save-state", at(f"{leg}_2.npz")])
        as_reference(before)
        first = vit_state_fit([*flags, *data, "--epochs", "1", "--save-state", at(f"{leg}_1.npz")])
        resumed = vit_state_fit([*flags, *data, "--epochs", "1", "--resume-state",
                                 at(f"{leg}_1.npz"), "--save-state", at(f"{leg}_r.npz")])
        mode = "flash_partial" if leg.startswith("sp1") else "flash_fwd"
        ok[f"vit_{leg}"] = {
            "resumed_equal_uninterrupted": same_state(torch, resumed, full),
            "archives_equal": same_archive(np, at(f"{leg}_r.npz"), at(f"{leg}_2.npz")),
            "resumed_lines_are_epoch_2": resumed["lines"][0].startswith("Train Epoch: 2 ")
            and resumed["lines"] == full["lines"][len(first["lines"]):],
            "launches_equal_attention_calls": all(
                r["launches"][mode] == n * depth * epoch_calls
                for r, n in ((full, 2), (first, 1), (resumed, 1)))}
        record[f"vit_{leg}"] = {"steps": resumed["step"],
                                "launches": {m: first["launches"][m] + resumed["launches"][m]
                                             for m in fa.LAUNCHES},
                                "epoch_wall_s": resumed["wall"],
                                "archive_bytes": os.path.getsize(at(f"{leg}_1.npz"))}

    # (b) two gloo ranks sharing the card: the --resume-reshard archive, the
    # --tp 2 / --pp legs and --tp 2 --save-model; (c) four: --tp 2 on 2 x 2
    refs = {bf16: cnn_dp_reference(torch, np, batches, bf16) for bf16 in (False, True)}
    mid = at("mid.npz")
    with ThreadPoolExecutor(2) as pool:  # the two worlds' processes at once
        two_done = pool.submit(state_gloo_world, 2, workdir, {
            "legs": STATE_TWO, "batches": batches, "reshard": (root, mid),
            "tp_save": (root, at("tp2.pt"))})
        four_done = pool.submit(state_gloo_world, 4, workdir,
                                {"legs": STATE_FOUR, "batches": batches})
        (two, two_s), (four, four_s) = two_done.result(), four_done.result()
    check(all(r["backend"] == "gloo" for r in two + four), "train_state ranks not gloo")
    legs = {}
    for ranks, names in ((two, STATE_TWO), (four, STATE_FOUR)):
        for leg in names:
            legs[f"gloo{len(ranks)}_{leg}"] = hold_mp_leg(torch, leg, ranks,
                                                           refs[STATE_MP_LEGS[leg][1]])
    saved = torch.load(at("tp2.pt"), weights_only=True)
    gathered = two[0]["tp_save"]["state"]
    ok["tp2_save_model"] = {
        "file_is_gathered_state": list(saved) == [f"module.{k}" for k in gathered]
        and all(torch.equal(saved[f"module.{k}"], v) for k, v in gathered.items()),
        "ranks_gathered_equal": all(torch.equal(two[1]["tp_save"]["state"][k], v)
                                    for k, v in gathered.items()),
        "one_epoch_of_steps": two[0]["tp_save"]["step"] == VIT_PAR_STEPS}

    # (d) an NCCL world of one through the launcher (this script the rank
    # program): --zero --flash saved and resumed, a plain archive resumed
    # under --zero, and the two ranks' mid-epoch archive with --resume-reshard
    zero = ["--zero", "--flash", *data]
    spec = {"vit": [[*zero, "--epochs", "2", "--save-state", at("zero_2.npz")],
                    [*zero, "--epochs", "1", "--save-state", at("zero_1.npz")],
                    [*zero, "--epochs", "1", "--resume-state", at("zero_1.npz"),
                     "--save-state", at("zero_r.npz")],
                    [*zero, "--epochs", "1", "--resume-state", at("flash_1.npz"),
                     "--save-state", at("plain_to_zero.npz")]],
            "reshard": ["--batch-size", str(2 * STATE_RANK_BATCH), "--epochs", "1",
                        "--pallas-opt", "--log-interval", "1", "--resume-state", mid,
                        "--resume-reshard", *data]}
    with open(at("state_spec.json"), "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         "--nproc_per_node=1", f"--master_port={free_port()}", os.path.abspath(__file__),
         "--state-rank", at("state_counts"), at("state_spec.json")],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=600)
    nccl_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"train_state launcher leg exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    nccl = torch.load(at("state_counts") + ".rank0", weights_only=False)
    check(nccl["backend"] == "nccl", f"train_state launcher leg formed {nccl['backend']}")
    zfull, zfirst, zres, p2z = nccl["vit"]
    z2p = vit_state_fit(["--flash", *data, "--epochs", "1", "--resume-state", at("zero_1.npz"),
                         "--save-state", at("zero_to_plain.npz")])
    ok["vit_zero_flash_nccl1"] = {
        "resumed_equal_uninterrupted": same_state(torch, zres, zfull),
        "archives_equal": same_archive(np, at("zero_r.npz"), at("zero_2.npz")),
        "plain_archive_under_zero": same_archive(np, at("plain_to_zero.npz"),
                                                 at("flash_2.npz")),
        "zero_archive_without_zero": same_archive(np, at("zero_to_plain.npz"),
                                                  at("zero_2.npz")),
        "launches_equal_attention_calls": all(
            r["launches"]["flash_fwd"] == n * depth * epoch_calls
            for r, n in ((zfull, 2), (zfirst, 1), (zres, 1), (p2z, 1), (z2p, 1)))}
    record["vit_zero_flash_nccl1"] = {"launches": {m: sum(r["launches"][m] for r in nccl["vit"])
                                                   - zfull["launches"][m] for m in fa.LAUNCHES},
                                      "launcher_wall_s": nccl_s}

    # --resume-reshard: the two ranks' epoch against the world of one's
    # continuation from batch STATE_CURSOR; without the flag, JAX's refusal
    two_loss = torch.stack([r["reshard"]["losses"] for r in two]).mean(0)
    got = nccl["reshard"]
    resumed_losses = torch.tensor([float(m.group(5)) for m in map(TRAIN_LINE.match, got["lines"])
                                   if m])
    param_diff = max(float((got["state"][k] - two[0]["reshard"]["state"][k]).abs().max())
                     for k in got["state"])
    refused = ""
    try:
        fit_run(["--batch-size", str(2 * STATE_RANK_BATCH), "--epochs", "1", "--pallas-opt",
                 "--resume-state", mid, *data])
    except ValueError as e:
        refused = str(e)
    ok["resume_reshard"] = {
        "archive_world_size_2": load_train_state_full(mid)[2]["world_size"] == 2,
        "steps": got["step"] == two[0]["reshard"]["step"] == VIT_PAR_STEPS
        and len(resumed_losses) == VIT_PAR_STEPS - STATE_CURSOR,
        "within_gates": torch.allclose(resumed_losses, two_loss[STATE_CURSOR:],
                                       rtol=DDP_LOSS_RTOL, atol=DDP_LOSS_ATOL)
        and param_diff <= DDP_PARAM_ATOL,
        "refused_without_the_flag": "pass --resume-reshard" in refused}
    record["resume_reshard"] = {
        "max_abs_loss_diff": float((resumed_losses - two_loss[STATE_CURSOR:]).abs().max()),
        "max_abs_param_diff": param_diff, "refusal": refused[:120],
        "rank_launches": [r["reshard"]["launches"] for r in two]}

    # (e) CNN --elastic in this process: --epochs 1, then 2, then 2 again
    limit = ["--pallas-opt", "--train-limit", str(RESUME_LIMIT)]
    before = counts()
    full = fit_run([*limit, "--epochs", "2"])
    as_reference(before)
    elastic = [fit_run([*limit, "--epochs", str(n), "--save-state", at("elastic.npz"),
                        "--elastic"]) for n in (1, 2, 2)]
    ok["cnn_elastic"] = {
        "second_equal_uninterrupted": all(same_run(torch, elastic[1], full).values()),
        "third_trains_no_step": elastic[2]["state"].step == full["state"].step
        and not any(ln.startswith("Train Epoch") for ln in elastic[2]["lines"]),
        "delta_kernel_once_a_step": [e["launches"]["adadelta_delta"] for e in elastic] == [
            elastic[0]["state"].step, elastic[0]["state"].step, 0]}

    # (f) --profile: one --pallas-opt CNN epoch and one ViT --flash epoch
    prof = {"cnn": profiled_epoch(fit_run, [*limit, "--epochs", "1"], at("prof_cnn"),
                                  "adadelta_kernel", "adadelta_delta"),
            "vit": profiled_epoch(vit_state_fit, ["--flash", *data, "--epochs", "1"],
                                  at("prof_vit"), "flash_kernel", "flash_fwd")}
    for name, p in prof.items():
        ok[f"profile_{name}"] = p.pop("ok")
        p.pop("runs")

    launches = {k: v - refs0[k] - references[k] for k, v in counts().items()}
    for k in launches:  # the ranks'; the launcher's uninterrupted --zero run a reference
        references[k] += zfull["launches"].get(k, 0)
        launches[k] += (nccl["launches"][k] - zfull["launches"].get(k, 0)
                        + sum(r["reshard"]["launches"].get(k, 0) for r in two))
    emit({"phase": "train_state", "steps_an_epoch": VIT_PAR_STEPS, "legs": legs,
          "checks": ok, "record": record, "profile": prof,
          "gates": {"loss_rtol": DDP_LOSS_RTOL, "loss_atol": DDP_LOSS_ATOL,
                    "param_atol": DDP_PARAM_ATOL, "bf16_atol": STATE_BF16_ATOL,
                    "mp_gate_steps": DDP_GATE_STEPS},
          "gloo2_wall_seconds": two_s, "gloo4_wall_seconds": four_s,
          "nccl_launcher_wall_seconds": nccl_s, "seconds": time.perf_counter() - t_phase,
          "launches": launches, "reference_launches": references})
    for name, checks in [*ok.items(), *((k, v["ok"]) for k, v in legs.items())]:
        check(all(checks.values()), f"train_state {name}: {checks}")
    return launches, references


def resilience_phase(torch, np, workdir: str) -> tuple[dict, dict]:
    """The resilience phase (module docstring, 20).  Returns the path's
    adadelta launches (this process's runs) and, apart, those of the
    references; the caller zeroes the counters first.  The flagless and
    the guarded runs go first, alone on the card, for the ms-a-step
    readings; then the three runs that must die or restart start together
    in processes of their own, and the other runs in this process go on
    meanwhile."""
    import os

    from pytorch_mnist_ddp_tpu_torch.obs import Registry, read_events
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.resilience.runtime import snapshot
    from pytorch_mnist_ddp_tpu_torch.serving import faults

    t_phase = time.perf_counter()
    root = vit_idx_root(np, workdir)
    at = functools.partial(os.path.join, workdir)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    cnn = ["--data-root", root, "--pallas-opt"]
    two = [*cnn, "--epochs", "2"]
    ckpt = ["--checkpoint-every-steps", str(RESILIENCE_CKPT)]
    cli = [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.mnist"]
    refs0 = dict(af.LAUNCHES)
    references = {k: 0 for k in refs0}

    def as_reference(run):
        for k, v in run["launches"].items():
            references[k] += v

    # the same two epochs flagless (a reference), and (d): the guard heals a
    # poisoned step (held to (a) below)
    flagless = fit_run(two)
    as_reference(flagless)
    with faults.injected("nan:step:after=5"):
        guarded = fit_run([*two, "--loss-guard", "--telemetry-dir", at("d_tel"), "--save-state",
                           at("d.npz")])
    snapshot_ms = median_ms(torch, lambda: snapshot(guarded["model"], guarded["state"]),
                            runs=20)

    procs, pool = {}, ThreadPoolExecutor(3)
    for name, cmd in (
            ("b", [*cli, *two, *ckpt, "--save-state", at("b.npz"), "--telemetry-dir",
                   at("b_tel"), "--chaos", f"kill:step:after={RESILIENCE_KILL_AFTER}"]),
            ("c", [*cli, *two, *ckpt, "--save-state", at("c.npz"), "--chaos",
                   "kill:ckpt_save:after=1"]),
            ("e", [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
                   "--nprocs", "1", "--restart-budget", "1", f"--master_port={free_port()}",
                   "--telemetry-dir", at("e_tel"), "-m", "pytorch_mnist_ddp_tpu_torch.mnist_ddp",
                   *two, "--batch-size", str(DDP_BATCH), "--save-state", at("e.npz"),
                   "--checkpoint-every-steps", "5", "--chaos", "kill:step:rank=0:after=9"])):
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=workdir, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        procs[name] = pool.submit(waited_process, proc, t0)

    # (a) the baseline
    reg_a = Registry()
    base = fit_run([*two, *ckpt, "--telemetry-dir", at("a_tel"), "--save-state", at("a.npz")],
                   registry=reg_a)
    steps = base["state"].step
    a_steps = [(e["epoch"], e["step"], e["loss"])
               for e in read_events(at("a_tel", "events-rank0.jsonl")) if e["event"] == "step"]
    ok, record = {}, {}
    ok["a_baseline"] = {
        "steps": steps == 2 * VIT_PAR_STEPS == len(a_steps),
        "delta_once_a_step": base["launches"]["adadelta_delta"] == steps,
        "lines_equal_flagless": base["lines"] == flagless["lines"],
        "equal_flagless": all(same_run(torch, base, flagless).values()),
        "two_checkpoints_a_epoch_on_cadence": reg_a.counter(
            "train_checkpoints_total", reason="periodic").value == steps // RESILIENCE_CKPT}

    prom_d = open(at("d_tel", "metrics.prom")).read()
    anomalies = [ln for ln in prom_d.splitlines() if ln.startswith("train_anomalies_total")]
    ok["d_guard"] = {
        "equal_a": all(same_run(torch, guarded, base).values()),
        "archive_equal_a": same_archive(np, at("d.npz"), at("a.npz")),
        "one_nan_anomaly": anomalies == ['train_anomalies_total{kind="nan"} 1'],
        "launches_a_plus_one": guarded["launches"]["adadelta_delta"]
        == base["launches"]["adadelta_delta"] + 1}

    def ms_a_step(run, epoch):  # the second epoch: no anomaly, no save in it for d
        return 1e3 * run["timings"]["epoch_train_s"][epoch] / run["timings"]["epoch_steps"][epoch]

    # (f) the fused path with telemetry: the counters from one read an epoch
    fused = fit_run(["--fused", *cnn, "--epochs", "1", "--telemetry-dir", at("f_tel")])
    prom_f = open(at("f_tel", "metrics.prom")).read()
    f_steps = fused["timings"]["epoch_steps"][0]
    ok["f_fused"] = {
        "steps_counter": f"train_steps_total {f_steps}" in prom_f.splitlines(),
        "samples_counter": f"train_samples_total {f_steps * 64}" in prom_f.splitlines(),
        "one_host_read_an_epoch": fused["timings"]["host_syncs"] == 1,
        "delta_once_a_step": fused["launches"]["adadelta_delta"] == f_steps == VIT_PAR_STEPS}

    # the processes: (b) and (c) died at their fault points, (e) restarted
    outs = {name: done.result() for name, done in procs.items()}
    pool.shutdown()
    for name, want in (("b", 137), ("c", 137), ("e", 0)):
        check(outs[name][0] == want, f"resilience ({name}) exited {outs[name][0]}, not "
                                     f"{want}: {outs[name][2][-2000:]}")

    # (b) the killed run resumed from its archive
    resumed_b = fit_run([*two, *ckpt, "--save-state", at("b.npz"), "--resume-state",
                         at("b.npz"), "--telemetry-dir", at("b_tel_resumed")])
    b_steps = [(e["epoch"], e["step"], e["loss"])
               for d in ("b_tel", "b_tel_resumed")
               for e in read_events(at(d, "events-rank0.jsonl")) if e["event"] == "step"]
    kill = RESILIENCE_KILL_AFTER
    cursor = kill // RESILIENCE_CKPT * RESILIENCE_CKPT
    ok["b_kill_resume"] = {
        "archive_equal_a": same_archive(np, at("b.npz"), at("a.npz")),
        "equal_a": all(same_run(torch, resumed_b, base).values()),
        "step_events_equal_a": b_steps[:kill] == a_steps[:kill]
        and b_steps[kill:] == a_steps[cursor:],
        "resumed_steps": resumed_b["launches"]["adadelta_delta"] == steps - cursor}

    # (c) killed inside the rotation: only the .prev archive is whole
    c_files = sorted(f for f in os.listdir(workdir) if f.startswith("c.npz"))
    resumed_c = fit_run([*two, "--save-state", at("c.npz"), "--resume-state", at("c.npz")])
    ok["c_kill_in_save"] = {
        "only_prev_and_new": c_files == ["c.npz.new", "c.npz.prev"],
        "archive_equal_a": same_archive(np, at("c.npz"), at("a.npz")),
        "equal_a": all(same_run(torch, resumed_c, base).values())}

    # (e) the gang restart against an uninterrupted run at batch 200
    e_ref = fit_run([*two, "--batch-size", str(DDP_BATCH), "--save-state", at("e_ref.npz")])
    as_reference(e_ref)
    launcher_prom = open(at("e_tel", "launcher.prom")).read().splitlines()
    events_e = [e["event"] for e in read_events(at("e_tel", "events-launcher.jsonl"))]
    restart = [e for e in read_events(at("e_tel", "events-launcher.jsonl"))
               if e["event"] == "gang_restart"]
    rdzv = [e["attempts"] for e in read_events(at("e_tel", "events-rdzv-rank0.jsonl"))
            if e["event"] == "rendezvous" and e["ok"]]
    ok["e_gang_restart"] = {
        "one_restart": "launch_restarts_total 1" in launcher_prom,
        "events": events_e == ["rank_death", "gang_restart"],
        "two_incarnations_formed": len(rdzv) == 2,
        "archive_equal_uninterrupted": same_archive(np, at("e.npz"), at("e_ref.npz")),
        "distributed_world_of_one": outs["e"][1].count(
            "| distributed init (rank 0): env://, local rank:0, world size:1") == 2}

    checkpoint_write = reg_a.histogram("checkpoint_write_seconds")
    launches = {k: v - refs0[k] - references[k] for k, v in af.LAUNCHES.items()}
    record = {
        "ms_a_step_epoch2": {"flagless": ms_a_step(flagless, 1),
                             "telemetry_guard": ms_a_step(guarded, 1),
                             "telemetry_checkpoint_beside_processes": ms_a_step(base, 1)},
        "snapshot_device_ms": snapshot_ms,
        "checkpoint_write_seconds": checkpoint_write.values(),
        "restart_wall_seconds": {"launcher": outs["e"][3],
                                 "downtime_s": restart[0]["downtime_s"] if restart else None},
        "rendezvous_attempts_by_incarnation": rdzv,
        "killed_wall_seconds": {"b": outs["b"][3], "c": outs["c"][3]},
        "fused_epoch_wall_s": fused["timings"]["epoch_wall_s"],
        "launches_by_leg": {"a": base["launches"], "d": guarded["launches"],
                            "f": fused["launches"], "b_resumed": resumed_b["launches"],
                            "c_resumed": resumed_c["launches"]}}
    emit({"phase": "resilience", "steps_an_epoch": VIT_PAR_STEPS, "checks": ok,
          "record": record, "launches": launches, "reference_launches": references,
          "seconds": time.perf_counter() - t_phase})
    for name, checks in ok.items():
        check(all(checks.values()), f"resilience {name}: {checks}")
    return launches, references


def _stamped_stdout(marks: dict):
    """This process's stdout, noting in ``marks`` (text -> None) the
    seconds from the process's start to the first write holding each
    text; everything written passes through unchanged."""
    real = sys.stdout

    class Stamped(io.TextIOBase):
        def write(self, text):
            for key, at in marks.items():
                if at is None and key in text:
                    marks[key] = time.perf_counter() - PROCESS_START
            return real.write(text)

        def flush(self):
            real.flush()

    return real, Stamped()


def _timed_library_loads() -> dict:
    """Times each library's first load in this process (its build, or its
    load from the store): ``ops._build.library`` wrapped in place."""
    from pytorch_mnist_ddp_tpu_torch.ops import _build

    seconds: dict = {}
    library = _build.library

    def timed(name, store=None):
        t0 = time.perf_counter()
        lib = library(name, store=store)
        seconds.setdefault(name, time.perf_counter() - t0)
        return lib

    _build.library = timed
    return seconds


def _startup_marks() -> dict:
    """Seconds from this process's start to torch imported and to the
    card's context ready (the first step or warmup then pays neither)."""
    import torch

    marks = {"torch_imported_s": time.perf_counter() - PROCESS_START}
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    marks["cuda_ready_s"] = time.perf_counter() - PROCESS_START
    return marks


def _library_report() -> dict:
    """What this process built and loaded: nvcc runs, loads, and each
    library's origin (its store's outcome), file and sha256."""
    import hashlib
    import os

    from pytorch_mnist_ddp_tpu_torch.ops import _build

    libraries = {}
    for name, lib in dict(_build._loaded).items():
        with open(lib._name, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        libraries[name] = {"origin": _build.origin(name), "sha256": digest,
                           "file": os.path.basename(lib._name)}
    return {"builds": _build.BUILDS, "loads": _build.LOADS, "libraries": libraries}


def compile_cli_program(argv: list[str]) -> int:
    """``chip_smoke.py --compile-cli OUT MODULE <flags>``: the compile
    phase's wrapper of a CLI.  ``mnist`` runs mnist.py's body
    (``mnist.run`` under ``run_cli``, what ``-m
    pytorch_mnist_ddp_tpu_torch.mnist`` runs, with fit's timings), and
    ``serving`` the serving CLI's ``main``; stdout is the CLI's own.  Then
    it writes to OUT what only this process sees: nvcc runs, libraries
    and their origins and sha256, launches, the seconds from its start to
    its first "Train Epoch" and "warmup verified" lines, each library's
    first load."""
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih

    out, module, flags = argv[0], argv[1], argv[2:]
    startup = _startup_marks()
    marks = {"Train Epoch": None, "warmup verified": None}
    seconds = _timed_library_loads()
    timings: dict = {}
    real, sys.stdout = _stamped_stdout(marks)
    try:
        if module == "mnist":
            from pytorch_mnist_ddp_tpu_torch import mnist

            args = mnist.build_parser().parse_args(flags)
            mnist.run_cli(args, lambda: mnist.run(args, timings))
            rc = 0
        else:
            from pytorch_mnist_ddp_tpu_torch.serving.__main__ import main as serve

            rc = serve(flags)
    finally:
        sys.stdout.flush()
        sys.stdout = real
    with open(out, "w") as f:
        json.dump({**_library_report(), "rc": rc, "first_line_s": marks, **startup,
                   "library_seconds": seconds,
                   "launches": {**af.LAUNCHES, "int8_head": ih.LAUNCHES},
                   "timings": {k: timings.get(k) for k in (
                       "startup_overlap_ratio", "compile_s", "restore_s", "data_s",
                       "epoch_steps")}}, f)
    return rc


def compile_serve_program(argv: list[str]) -> int:
    """``chip_smoke.py --compile-serve OUT STORE MODE``: engines of the
    full-width CNN (seed-SEED weights, --dtypes f32,int8, the kernel head)
    on the kernel-library store STORE, in a process of their own, each
    answering seeded rows at every bucket of the ladder (OUT.npz), OUT
    the process's report.  MODE ``handoff``: first the serving CLI's
    ``main`` with --warmup-only --dtypes f32,int8 --aot-cache STORE (its
    stdout, its launches and the seconds to its return kept; it loads
    int8_head), then the default engine and one without device staging
    (held to the default at every rung); ``pool``: a --replicas 2 pool,
    each replica's answers kept, and a second one warmed serially
    (--serial-warmup: the replicas in turn), held to the first at every
    rung; ``tampered``: the default engine alone (the caller tampered the
    store's entry); ``fault``: the same with fail:aot_load:count=1
    installed in this process first."""
    import numpy as np
    import torch

    from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
    from pytorch_mnist_ddp_tpu_torch.serving import faults
    from pytorch_mnist_ddp_tpu_torch.serving.engine import PARITY_SEED, InferenceEngine
    from pytorch_mnist_ddp_tpu_torch.serving.pool import EnginePool

    out, store, mode = argv
    startup = _startup_marks()
    seconds = _timed_library_loads()
    # the answers are compared across processes: no cuDNN choice by timing
    torch.backends.cudnn.deterministic = True
    injector = (faults.install(faults.FaultInjector("fail:aot_load:count=1")).start()
                if mode == "fault" else None)
    raw = np.random.RandomState(PARITY_SEED + 1).randint(0, 256, (128, 28, 28)).astype(np.uint8)
    x = normalize(raw)

    def answers(engine) -> dict:
        return {f"{dt}_{b}": engine.predict_logits(x[:b], dtype=dt)
                for dt in ("f32", "int8") for b in engine.buckets}

    def engine(**kwargs):
        return InferenceEngine.from_seed(SEED, dtypes=("int8",), aot_cache=store, **kwargs)

    report: dict = {"mode": mode, **startup}
    kept: dict = {}
    engines = []
    if mode == "handoff":
        from pytorch_mnist_ddp_tpu_torch.serving.__main__ import main as serve

        out_cli = io.StringIO()
        with contextlib.redirect_stdout(out_cli):
            rc = serve(["--warmup-only", "--dtypes", "f32,int8", "--aot-cache", store])
        report["cli"] = {**_library_report(), "rc": rc, "stdout": out_cli.getvalue(),
                         "int8_head_launches": ih.LAUNCHES,
                         "done_s": time.perf_counter() - PROCESS_START}
        ih.LAUNCHES = 0
    if mode == "pool":
        pool = EnginePool.from_seed(SEED, replicas=POOL_REPLICAS, dtypes=("int8",),
                                    aot_cache=store)
        pool.warmup()
        pool.verify_parity(raise_on_failure=True)
        report["warmup_done_s"] = time.perf_counter() - PROCESS_START
        engines = list(pool.engines)
        for i, e in enumerate(engines):
            kept.update({f"r{i}_{k}": v for k, v in answers(e).items()})
        serial = EnginePool.from_seed(SEED, replicas=POOL_REPLICAS, dtypes=("int8",),
                                      aot_cache=store)
        serial.warmup(parallel=False)
        serial.verify_parity(raise_on_failure=True)
        engines += serial.engines
        report["serial_warmup_equal"] = all(
            np.array_equal(got[k], kept[f"r{i}_{k}"])
            for i, got in enumerate(answers(e) for e in serial.engines) for k in got)
    else:
        default = engine()
        default.warmup()
        gate = default.verify_parity()["int8"]
        report["warmup_done_s"] = time.perf_counter() - PROCESS_START
        check(gate["passed"], f"compile-serve {mode}: int8 gate failed: {gate}")
        engines = [default]
        kept = answers(default)
        if mode == "handoff":
            unstaged = engine(device_stage=False)
            unstaged.warmup()
            unstaged.verify_parity()
            engines.append(unstaged)
            got = answers(unstaged)
            report["no_device_stage_equal"] = all(np.array_equal(got[k], kept[k]) for k in kept)
    n = len(engines[0].buckets)
    report.update(_library_report(), library_seconds=seconds,
                  int8_head_launches=ih.LAUNCHES,
                  # each engine: its int8 rungs, its gate, one answer a bucket
                  int8_head_expected=len(engines) * (2 * n + 1),
                  fired=injector.fired_counts() if injector is not None else {})
    np.savez(out + ".npz", **kept)
    with open(out, "w") as f:
        json.dump(report, f)
    return 0


def no_nvcc_env(env: dict, missing: str) -> dict:
    """``env`` on a host without the CUDA toolkit: CUDA_HOME and CUDA_PATH
    name the directory ``missing`` and no PATH entry holds nvcc."""
    import os

    return {**env, "CUDA_HOME": missing, "CUDA_PATH": missing,
            "PATH": os.pathsep.join(d for d in env.get("PATH", "").split(os.pathsep)
                                    if not os.path.exists(os.path.join(d, "nvcc")))}


def compile_phase(torch, np, workdir: str, smi: str) -> tuple[dict, dict]:
    """The compile phase (module docstring, 21).  Returns the path's
    int8_head and adadelta_delta launches, counted by its processes, and
    apart those of the flagless references."""
    import os
    import shutil

    from pytorch_mnist_ddp_tpu_torch.compile import ExecutableStore
    from pytorch_mnist_ddp_tpu_torch.compile.aot import _sha256
    from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
    from pytorch_mnist_ddp_tpu_torch.ops import _build
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.trainer import fit

    t_phase = time.perf_counter()
    root = vit_idx_root(np, workdir)
    at = functools.partial(os.path.join, workdir)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    store = at("aot")
    train = ["--epochs", "1", "--pallas-opt", "--data-root", root]

    # The serving host of the handoff has no toolkit: nvcc_path() raises
    # there, so a process that needed nvcc for a hit would fail.
    no_nvcc = no_nvcc_env(env, at("no_toolkit"))

    def start(name: str, kind: str, *argv, toolkit: bool = True) -> tuple:
        run_dir = at(name)
        os.makedirs(run_dir)
        cmd = [sys.executable, os.path.join(here, "chip_smoke.py"), f"--compile-{kind}",
               at(f"{name}.json"), *argv]
        return name, subprocess.Popen(cmd, cwd=run_dir, env=env if toolkit else no_nvcc,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)

    def finish(group) -> dict:
        """Each process's report and stdout; whichever way this ends, no
        process of the group is left running."""
        done = {}
        try:
            for name, proc in group:
                rc, stdout, stderr, _ = waited_process(proc, 0.0, COMPILE_PROC_TIMEOUT_S)
                check(rc == 0, f"compile ({name}) exited {rc}: {stderr[-3000:]}")
                with open(at(f"{name}.json")) as f:
                    done[name] = {**json.load(f), "stdout": stdout}
        finally:
            for _, proc in group:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        return done

    def saved(name: str) -> bytes:
        with open(at(name, "mnist_cnn.pt"), "rb") as f:
            return f.read()

    def flagless(name: str, *flags) -> str:
        """mnist.py's body with ``flags`` in this process (its libraries
        the build phase's); its stdout."""
        os.makedirs(at(name))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            fit(build_parser().parse_args(list(flags)), "cuda",
                save_path=at(name, "mnist_cnn.pt"))
        return out.getvalue()

    def prom(name: str) -> list[str]:
        with open(at(f"{name}_tel", "metrics.prom")) as f:
            return f.read().splitlines()

    def origins(run: dict) -> dict:
        return {k: v["origin"] for k, v in run["libraries"].items()}

    def loaded(run: dict, name: str, key: str):
        return run["libraries"].get(name, {}).get(key)

    # (a) cold, in a process of its own; the two flagless references run
    # in this process meanwhile
    cold_run = [start("a", "cli", "mnist", *train, "--save-model", "--aot-cache", store,
                      "--serve-prewarm", "--telemetry-dir", at("a_tel"))]
    before = dict(af.LAUNCHES)
    t0 = time.perf_counter()
    stdout = {"flagless": flagless("flagless", *train, "--save-model"),
              "flagless_fused": flagless("flagless_fused", "--fused", *train)}
    flagless_s = time.perf_counter() - t0
    references = {k: af.LAUNCHES[k] - before[k] for k in before}
    runs = finish(cold_run)
    cold = {name: ExecutableStore(store).entry(name) for name in ("adadelta", "int8_head")}
    for name, tamper in (("tampered", True), ("fault", False)):
        shutil.copytree(store, at(f"aot_{name}"))
        if tamper:
            header = ExecutableStore(at("aot_tampered")).header_path("int8_head")
            with open(header) as f:
                entry = json.load(f)
            with open(header, "w") as f:
                json.dump({**entry, "torch_version": "0.0.0"}, f)
    # (b)-(e) together
    runs.update(finish([
        start("b", "cli", "mnist", *train, "--save-model", "--aot-cache", store,
              "--serve-prewarm", "--telemetry-dir", at("b_tel")),
        start("fused", "cli", "mnist", "--fused", *train, "--aot-cache", store),
        start("handoff", "serve", store, "handoff", toolkit=False),
        start("pool", "serve", store, "pool", toolkit=False),
        start("tampered", "serve", at("aot_tampered"), "tampered"),
        start("fault", "serve", at("aot_fault"), "fault")]))
    answers = {name: dict(np.load(at(f"{name}.json.npz"))) for name in
               ("handoff", "pool", "tampered", "fault")}
    a, b, steps = runs["a"], runs["b"], VIT_PAR_STEPS
    ok = {}
    ok["a_cold"] = {
        "misses": origins(a) == {"adadelta": "miss", "int8_head": "miss"},
        "two_nvcc_runs": a["builds"] == 2,
        "outcome_counter": 'aot_executables_total{outcome="miss"} 2' in prom("a"),
        "delta_once_a_step": a["launches"]["adadelta_delta"] == steps,
        "entries_written": all(e is not None for e in cold.values()),
        "flagless_from_the_build_store": _build.origin("adadelta") in ("hit", "miss")
        and os.path.dirname(_build._loaded["adadelta"]._name)
        == _build.build_store().directory,
        "flagless_delta_once_a_step": references["adadelta_delta"] == 2 * steps}
    ok["b_warm"] = {
        "hits": origins(b) == {"adadelta": "hit", "int8_head": "hit"},
        "no_nvcc_run": b["builds"] == 0,
        "outcome_counter": 'aot_executables_total{outcome="hit"} 2' in prom("b"),
        "the_cold_libraries": all(
            loaded(b, n, "sha256") == loaded(a, n, "sha256") == cold[n]["sha256"]
            for n in cold),
        "stdout_equal": b["stdout"] == a["stdout"] == stdout["flagless"] != "",
        "model_equal": saved("b") == saved("a") == saved("flagless"),
        "delta_once_a_step": b["launches"]["adadelta_delta"] == steps}
    fused, serving = runs["fused"], runs["handoff"]["cli"]
    ok["b_fused"] = {
        "hit": origins(fused) == {"adadelta": "hit"} and fused["builds"] == 0,
        "stdout_equal": fused["stdout"] == stdout["flagless_fused"] != "",
        "delta_once_a_step": fused["launches"]["adadelta_delta"] == steps,
        "overlap_ratio_recorded": isinstance(fused["timings"]["startup_overlap_ratio"], float)}
    handoff, pool = runs["handoff"], runs["pool"]
    ref = answers["handoff"]
    int8_keys = [k for k in ref if k.startswith("int8_")]
    ok["c_handoff"] = {
        "cli_no_nvcc_run": serving["rc"] == 0 and serving["builds"] == 0
        and origins(serving) == {"int8_head": "hit"}
        and ", 0 nvcc builds (AOT cache " in serving["stdout"],
        # the CLI's warmup (8 int8 rungs) and gate
        "cli_int8_launches": serving["int8_head_launches"] == 9,
        "engines_no_nvcc_run": handoff["builds"] == 0,
        "pool_hit": pool["builds"] == 0 and origins(pool) == {"int8_head": "hit"},
        "the_cold_library": all(loaded(r, "int8_head", "sha256") == cold["int8_head"]["sha256"]
                                for r in (serving, handoff, pool)),
        "replicas_equal_engine": all(
            np.array_equal(answers["pool"][f"r{i}_{k}"], ref[k])
            for i in range(POOL_REPLICAS) for k in int8_keys),
        "int8_launches": all(r["int8_head_launches"] == r["int8_head_expected"]
                             for r in (handoff, pool))}
    ok["d_fallback"] = {}
    for name in ("tampered", "fault"):
        run, rewritten = runs[name], ExecutableStore(at(f"aot_{name}"))
        entry = rewritten.entry("int8_head")
        ok["d_fallback"][name] = {
            "fallback": origins(run) == {"int8_head": "fallback"} and run["builds"] == 1,
            "rewritten": entry["file"] != cold["int8_head"]["file"]
            and entry["file"] == loaded(run, "int8_head", "file")
            and entry["sha256"] == _sha256(at(f"aot_{name}", entry["file"]))
            and all(entry[k] == v for k, v in rewritten.material("int8_head").items()),
            "fired": run["fired"] == ({"fail:aot_load:count=1": 1} if name == "fault" else {}),
            "answers_equal": all(np.array_equal(answers[name][k], ref[k]) for k in ref),
            "int8_launches": run["int8_head_launches"] == run["int8_head_expected"]}
    ok["e_variants"] = {"serial_warmup": pool["serial_warmup_equal"],
                        "no_device_stage": handoff["no_device_stage_equal"]}
    launches = {
        "int8_head": serving["int8_head_launches"] + sum(
            runs[n]["int8_head_launches"] for n in ("handoff", "pool", "tampered", "fault")),
        "adadelta_delta": sum(runs[n]["launches"]["adadelta_delta"]
                              for n in ("a", "b", "fused"))}
    compile_seconds = {name: [ln for ln in prom(name) if ln.startswith("compile_seconds_total")]
                       for name in ("a", "b")}
    record = {
        "nvidia_smi": smi,
        "first_step_s": {"cold": a["first_line_s"]["Train Epoch"],
                         "warm": b["first_line_s"]["Train Epoch"]},
        "torch_imported_s": {n: r["torch_imported_s"] for n, r in runs.items()},
        "cuda_ready_s": {n: r["cuda_ready_s"] for n, r in runs.items()},
        "flagless_in_process_s": flagless_s,
        "warmup_done_s": {"cold_tampered": runs["tampered"]["warmup_done_s"],
                          "cold_fault": runs["fault"]["warmup_done_s"],
                          "warm_cli_warmup_and_gate": serving["done_s"],
                          "warm_engine_after_the_cli": handoff["warmup_done_s"],
                          "warm_pool": pool["warmup_done_s"]},
        "compile_seconds_total": compile_seconds,
        "library_seconds": {n: runs[n]["library_seconds"] for n in runs},
        "fused": fused["timings"],
        "library_bytes": {n: e["bytes"] for n, e in cold.items()},
        "concurrent": {"a": ["this process: flagless, flagless_fused"],
                       "b": ["fused", "handoff", "pool", "tampered", "fault"]}}
    emit({"phase": "compile", "steps_an_epoch": steps, "checks": ok, "record": record,
          "launches": launches, "reference_launches": references,
          "seconds": time.perf_counter() - t_phase})
    for name, checks in ok.items():
        flat = checks if name != "d_fallback" else {f"{k}.{c}": v for k, d in checks.items()
                                                    for c, v in d.items()}
        check(all(flat.values()), f"compile {name}: {checks}")
    return launches, references


def log_lines(lines: list[str]) -> list[str]:
    """The train and test lines of a run's output (the synthetic set's
    notice is printed once a process)."""
    return [ln for ln in lines if ln.startswith(("Train Epoch", "Test set"))]


def same_opt(torch, a, b) -> bool:
    """torch.equal of two optimizer states of one layout: flat, ZeRO-1
    chunks or per-leaf trees."""
    if type(a) is not type(b):
        return False
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x) if isinstance(
        a[0], dict) else all(torch.equal(x, y) for x, y in zip(a, b))


def fused_rank_program(argv: list[str]) -> int:
    """``chip_smoke.py --fused-rank OUT SPEC``: the rank program of the
    fused phase's NCCL world of one (the launcher's environment).  SPEC
    (JSON) lists ``[name, mnist_ddp flags, save path or null]`` runs, each
    through the trainer's body in this world; writes each run's lines,
    step, state, accumulators, timings and adadelta launches, and the
    backend, to OUT."""
    import os

    import torch
    import torch.distributed as dist

    from pytorch_mnist_ddp_tpu_torch import trainer
    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import destroy_distributed, form_world

    out, spec = argv[0], json.load(open(argv[1]))
    world = form_world()
    result = {"backend": dist.get_backend()}
    try:
        for name, flags, save_path in spec:
            timings: dict = {}
            before = dict(af.LAUNCHES)
            lines = io.StringIO()
            with contextlib.redirect_stdout(lines):
                net, state = trainer._fit(build_parser().parse_args(flags), None, save_path,
                                          timings, world)
            result[name] = {
                "lines": [ln for ln in lines.getvalue().splitlines() if ln],
                "step": state.step,
                "state": {k: v.detach().cpu() for k, v in net.state_dict().items()},
                "opt": type(state.opt)(*(
                    {k: v.cpu() for k, v in t.items()} if isinstance(t, dict) else t.cpu()
                    for t in state.opt)),
                "timings": {k: timings.get(k) for k in ("epoch_wall_s", "epoch_train_s",
                                                        "host_syncs", "replays")},
                "launches": {k: af.LAUNCHES[k] - before[k] for k in before}}
    finally:
        destroy_distributed()
    torch.save(result, f"{out}.rank{os.environ['RANK']}")
    return 0


def fused_phase(torch, np, workdir: str, per_batch: dict) -> tuple[dict, dict]:
    """The fused path (``--fused``, ``parallel/fused.py``) and the
    prefetch (``--prefetch-depth``) on the card, TF32 off, deterministic
    cuDNN.  (a) WARMUP_STEPS eager and FUSED_CAPTURED replayed steps of
    the fused epoch against as many per-batch steps on the loader's
    batches of epoch 1 from the same weights, dropout on, plain and
    --pallas-opt: parameters, accumulators and losses torch.equal, row 3
    once a replay.  (b) mnist.py --fused --pallas-opt, two epochs, against
    the train phase's own two --pallas-opt epochs (``per_batch``): the
    same bits and lines, epoch-1 accuracy, s/epoch both ways, host reads
    an epoch; --fused --pregather against --fused at --train-limit.
    (c) --prefetch-depth 0 against the default 2 at --train-limit: the
    same bits and lines; s/epoch and the median data_wait_seconds each.
    (d) mnist_ddp in an NCCL world of one through the launcher (this
    script the rank program): --fused --pallas-opt --save-model equal to
    (b), --fused --zero and --fused --syncbn --pallas-opt equal to their
    per-batch runs at --train-limit (two gloo ranks sharing the card are
    refused with the NCCL ValueError in the ddp phase's gloo world, which
    the same ranks serve).  (e) FUSED_PROFILE_STEPS replays
    under torch.profiler.  Returns the adadelta launches of the fused and
    prefetching paths and, apart, those of the references."""
    import itertools
    import os

    from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
    from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.obs.registry import Registry
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.parallel import fused
    from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state, make_train_step
    from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import load_inference_state
    from pytorch_mnist_ddp_tpu_torch.utils.rng import split_streams

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    path = {k: 0 for k in af.LAUNCHES}
    references = {k: 0 for k in af.LAUNCHES}
    start = dict(af.LAUNCHES)

    def add(into: dict, launches: dict) -> None:
        for k in into:
            into[k] += launches[k]

    def since(before: dict) -> dict:
        return {k: af.LAUNCHES[k] - before[k] for k in before}

    # (a) captured against eager
    images, labels = synthetic_mnist("train")
    loader = DataLoader(images, labels, 64, torch.device("cuda"), seed=1)
    seed = split_streams(1)["dropout"]
    steps = fused.WARMUP_STEPS + FUSED_CAPTURED
    captured = {}
    for leg, pallas in (("plain", False), ("pallas_opt", True)):
        net = Net(torch.Generator().manual_seed(SEED)).cuda()
        state = make_train_state(net, use_pallas=pallas)
        step = make_train_step(use_pallas=pallas, dropout_seed=seed)
        before = dict(af.LAUNCHES)
        eager = torch.stack([step(net, state, x, y, w, 1.0)
                             for x, y, w in itertools.islice(loader.epoch(1), steps)])
        add(references, since(before))
        fnet = Net(torch.Generator().manual_seed(SEED)).cuda()
        fstate = make_train_state(fnet, use_pallas=pallas)
        run = fused.FusedEpoch(fnet, fstate, loader, dropout_seed=seed, use_pallas=pallas)
        before = dict(af.LAUNCHES)
        run.load(1, 1.0)
        for _ in range(fused.WARMUP_STEPS):
            run.step()
        mid = dict(af.LAUNCHES)
        for _ in range(FUSED_CAPTURED):
            run.step()
        torch.cuda.synchronize()
        replayed = since(mid)["adadelta_delta"]
        add(path, since(before))
        same = {"params": all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                                fnet.parameters())),
                "accumulators": same_opt(torch, state.opt, fstate.opt),
                "losses": torch.equal(eager, run.losses[:steps]),
                "step": state.step == fstate.step == steps}
        captured[leg] = {"steps": steps, "eager_steps": run.eager_steps,
                         "replays": run.replays, "row3_launches_in_replays": replayed,
                         "recorded_in_graph": run.recorded, "torch_equal": same}
        check(all(same.values()), f"fused (a) {leg}: the captured steps off the eager: {same}")
        check(run.graph is not None and run.replays == FUSED_CAPTURED,
              f"fused (a) {leg}: {run.replays} replays")
        check(replayed == (run.replays if pallas else 0),
              f"fused (a) {leg}: row 3 launched {replayed} times in {run.replays} replays")
        check(run.recorded == {"adadelta_delta": int(pallas), "adadelta_fused": 0},
              f"fused (a) {leg}: the capture recorded {run.recorded}")
    del loader

    # (b) the CLI against the train phase's per-batch epochs
    fused_run = fit_run(["--epochs", "2", "--pallas-opt", "--fused"])
    add(path, fused_run["launches"])
    timings = fused_run["timings"]
    same_b = {**same_run(torch, fused_run, per_batch),
              "lines": log_lines(fused_run["lines"]) == log_lines(per_batch["lines"])}
    acc1 = timings["epoch1_test_accuracy"]
    check(all(same_b.values()), f"fused (b): --fused off the per-batch epochs: {same_b}")
    check(acc1 >= EPOCH1_MIN_ACCURACY, f"fused (b): epoch-1 accuracy {acc1}")
    check(fused_run["launches"]["adadelta_delta"] == fused_run["state"].step,
          f"fused (b): row 3 {fused_run['launches']} for {fused_run['state'].step} steps")
    root = vit_idx_root(np, workdir, FUSED_LIMIT, "fused_idx")
    limited = ["--data-root", root, "--epochs", "2", "--pallas-opt"]
    gather = fit_run([*limited, "--fused"])
    pregather = fit_run([*limited, "--fused", "--pregather"])
    add(path, gather["launches"])
    add(path, pregather["launches"])
    same_pre = {**same_run(torch, gather, pregather),
                "lines": log_lines(gather["lines"]) == log_lines(pregather["lines"])}
    check(all(same_pre.values()), f"fused (b): --pregather off --fused: {same_pre}")
    cli = {"torch_equal_to_per_batch": same_b, "epoch1_test_accuracy": acc1,
           "seconds_per_epoch": {"fused": timings["epoch_wall_s"],
                                 "per_batch": per_batch["timings"]["epoch_wall_s"],
                                 "per_batch_train_only": per_batch["timings"]["epoch_train_s"]},
           "host_syncs_per_epoch": timings["host_syncs"] / len(timings["epoch_wall_s"]),
           "eager_steps": 2 * timings["epoch_steps"][0] - timings["replays"],
           "replays": timings["replays"], "launches": fused_run["launches"],
           "pregather_torch_equal": same_pre,
           "pregather_seconds_per_epoch": {"gather": gather["timings"]["epoch_wall_s"],
                                           "pregather": pregather["timings"]["epoch_wall_s"]}}

    # (c) prefetch depth 0 against the default 2, the per-batch path, in
    # turns (2, 0, 0, 2): the first run of a process pays set-up the others
    # do not
    depths: dict[int, list] = {2: [], 0: []}
    for depth in (2, 0, 0, 2):
        registry = Registry()
        run = fit_run([*limited[:-3], "--epochs", "1", "--pallas-opt",
                       "--prefetch-depth", str(depth)], registry=registry)
        add(path if depth else references, run["launches"])
        waits = registry.histogram("data_wait_seconds", pipeline="train").values()
        occupancy = registry.histogram("prefetch_buffer_occupancy", pipeline="train").values()
        depths[depth].append({"run": run, "report": {
            "seconds_per_epoch": run["timings"]["epoch_train_s"][0],
            "median_data_wait_ms": 1e3 * statistics.median(waits), "consumes": len(waits),
            "mean_occupancy": statistics.fmean(occupancy)}})
    first = depths[2][0]["run"]
    same_c = {f"depth_{d}_run_{i}": same_run(torch, first, r["run"]) == {
        "params": True, "square_avg": True, "acc_delta": True, "step": True}
        and log_lines(first["lines"]) == log_lines(r["run"]["lines"])
        for d, runs in depths.items() for i, r in enumerate(runs)}
    check(all(same_c.values()), f"fused (c): the prefetch depths' runs differ: {same_c}")
    prefetch = {"torch_equal_to_the_first": same_c,
                **{f"depth_{d}": [r["report"] for r in runs] for d, runs in depths.items()}}
    del depths

    # (d) mnist_ddp in an NCCL world of one, and two gloo ranks refused
    spec = [["fused_pallas_opt", ["--epochs", "2", "--pallas-opt", "--fused", "--save-model"],
             "mnist_cnn.pt"],
            ["fused_zero", [*limited[:-1], "--zero", "--fused"], None],
            ["zero", [*limited[:-1], "--zero"], None],
            ["fused_syncbn", [*limited, "--syncbn", "--fused"], None],
            ["syncbn", [*limited, "--syncbn"], None]]
    with open(os.path.join(workdir, "fused_spec.json"), "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         "--nproc_per_node=1", f"--master_port={free_port()}", os.path.abspath(__file__),
         "--fused-rank", os.path.join(workdir, "fused_counts"),
         os.path.join(workdir, "fused_spec.json")],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=600)
    nccl_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"fused (d) launcher exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    rank0 = torch.load(os.path.join(workdir, "fused_counts.rank0"), weights_only=False)
    check(rank0["backend"] == "nccl", f"fused (d) formed {rank0['backend']}")
    saved = load_inference_state(os.path.join(workdir, "mnist_cnn.pt"))
    want = {k: v.cpu() for k, v in fused_run["model"].state_dict().items()}
    lead = rank0["fused_pallas_opt"]
    same_d = {"mnist_cnn_pt": sorted(saved) == sorted(want)
              and all(torch.equal(saved[k], want[k]) for k in want),
              "lines": log_lines(lead["lines"]) == log_lines(fused_run["lines"])}
    for name, ref in (("fused_zero", "zero"), ("fused_syncbn", "syncbn")):
        a, b = rank0[name], rank0[ref]
        same_d[name] = (log_lines(a["lines"]) == log_lines(b["lines"]) and a["step"] == b["step"]
                        and all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
                        and same_opt(torch, a["opt"], b["opt"]))
    check(all(same_d.values()), f"fused (d): the NCCL world of one: {same_d}")
    for name in ("fused_pallas_opt", "fused_zero", "fused_syncbn"):
        add(path, rank0[name]["launches"])
        check(rank0[name]["timings"]["replays"] > 0, f"fused (d) {name}: no replay")
    add(references, rank0["syncbn"]["launches"])
    add(references, rank0["zero"]["launches"])
    check(lead["launches"]["adadelta_delta"] == lead["step"]
          and rank0["fused_syncbn"]["launches"]["adadelta_delta"] == rank0["fused_syncbn"]["step"],
          "fused (d): row 3 not once a step")
    ddp = {"nccl_world_of_one": {"torch_equal": same_d, "launcher_wall_seconds": nccl_s,
                                 **{name: {"step": r["step"], "timings": r["timings"],
                                           "launches": r["launches"]}
                                    for name, r in rank0.items() if name != "backend"}},
           "gloo_two_ranks": "refused in the ddp phase's gloo world (fused_refused)"}

    # (e) where a replayed step's time goes
    images, labels = synthetic_mnist("train")
    loader = DataLoader(images, labels, 64, torch.device("cuda"), seed=1)
    net = Net(torch.Generator().manual_seed(SEED)).cuda()
    run = fused.FusedEpoch(net, make_train_state(net, use_pallas=True), loader,
                           dropout_seed=seed, use_pallas=True)
    before = dict(af.LAUNCHES)
    run.load(1, 1.0)
    for _ in range(fused.WARMUP_STEPS + 10):  # the capture, then a few replays
        run.step()
    torch.cuda.synchronize()
    window = dict(af.LAUNCHES)
    profile = profile_window(torch, [(None, None, None)] * FUSED_PROFILE_STEPS,
                             lambda *_: run.step(), find="adadelta")
    counted = since(window)["adadelta_delta"]
    add(path, since(before))
    # the counts of replays are worked out from the capture; the device's
    # own record shows that the graph launches the kernel once a replay
    on_device = sum(v["calls"] for k, v in profile["found"].items() if k.startswith("device "))
    check(run.recorded == {"adadelta_delta": 1, "adadelta_fused": 0},
          f"fused (e): the capture recorded {run.recorded}")
    check(on_device == counted == FUSED_PROFILE_STEPS,
          f"fused (e): row 3 on the device {on_device} times, counted {counted}, "
          f"in {FUSED_PROFILE_STEPS} replays ({profile['device_ops_per_step']} device "
          f"ops a replay, {profile['launches_without_a_device_record']} launches with no "
          f"device record, {profile['prefix_records_lost']} of the prefix's lost)")
    local = since(start)
    emit({"phase": "fused", "captured_vs_eager": captured, "cli": cli, "prefetch": prefetch,
          "mnist_ddp": ddp, "profile_pallas_opt": profile, "launches": path,
          "reference_launches": references, "seconds": time.perf_counter() - t_phase})
    check(all(local[k] == path[k] + references[k]
              - sum(rank0[n]["launches"][k] for n in rank0 if n != "backend")
              for k in local), f"fused phase launched {local} in this process outside its legs")
    return path, references


def http_post(url: str, data: bytes, ctype: str = "application/json") -> tuple[int, bytes, str]:
    """POST ``data``; ``(status, body, content type)`` whatever the status."""
    import urllib.error

    req = urllib.request.Request(url, data, {"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def predict_body(rows, dtype: str | None = None, qos: str | None = None) -> bytes:
    body = {"instances": rows.reshape(len(rows), -1).tolist(), "return_log_probs": True}
    if dtype is not None:
        body["dtype"] = dtype
    if qos is not None:
        body["qos"] = qos
    return json.dumps(body).encode()


def log_probs(body: bytes):
    import numpy as np

    return np.asarray(json.loads(body)["log_probs"], np.float32)


def poll(predicate, what: str, timeout_s: float = 20.0) -> None:
    deadline = time.perf_counter() + timeout_s
    while not predicate():
        check(time.perf_counter() < deadline, f"timed out waiting for {what}")
        time.sleep(0.002)


def bn_net(torch, seed: int):
    """A --syncbn CNN from ``seed`` with running averages and BN scales
    moved off their init (so the eval-mode BatchNorm is not the identity)."""
    from pytorch_mnist_ddp_tpu_torch.models.net import Net

    g = torch.Generator().manual_seed(seed)
    net = Net(g, use_bn=True)
    with torch.no_grad():
        for bn in (net.bn1, net.bn2):
            bn.running_mean.copy_(0.1 * torch.randn(bn.running_mean.shape, generator=g))
            bn.running_var.copy_(1 + 0.5 * torch.rand(bn.running_var.shape, generator=g))
            bn.weight.copy_(1 + 0.2 * torch.randn(bn.weight.shape, generator=g))
    return net


def serving_stack_phase(torch, np, workdir: str) -> tuple[dict, dict]:
    """The single-engine serving stack on the card: one packed server over
    a registry of two seeded versions, --dtypes f32,bf16,int8 --int8-impl
    pallas --response-cache 256, telemetry on.  Checks (a)-(i) of the
    module docstring; returns row 1's launches on the path and, apart,
    those of the references it is held to."""
    import os

    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.models.quant import (
        conv_stack,
        int8_head_dot,
        qparams_to,
        quantize_params,
    )
    from pytorch_mnist_ddp_tpu_torch.obs.events import open_sink, read_events
    from pytorch_mnist_ddp_tpu_torch.obs.spans import span
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
    from pytorch_mnist_ddp_tpu_torch.serving import faults, wire
    from pytorch_mnist_ddp_tpu_torch.serving.batcher import MicroBatcher
    from pytorch_mnist_ddp_tpu_torch.serving.engine import PARITY_SEED, InferenceEngine
    from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
    from pytorch_mnist_ddp_tpu_torch.serving.registry import ModelRegistry
    from pytorch_mnist_ddp_tpu_torch.serving.rollout import (
        RolloutController,
        canary_assignment,
    )
    from pytorch_mnist_ddp_tpu_torch.serving.server import decode_instances, make_server
    from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import model_state_dict, save_state_dict

    t_phase = time.perf_counter()
    refs = {"launches": 0}

    @contextlib.contextmanager
    def reference():
        before = ih.LAUNCHES
        try:
            yield
        finally:
            refs["launches"] += ih.LAUNCHES - before

    # The registry: v1 (SEED) the default, v2 published beside it.
    reg_dir = os.path.join(workdir, "registry")
    os.makedirs(reg_dir)
    states = {"v1": Net(torch.Generator().manual_seed(SEED)).state_dict(),
              "v2": Net(torch.Generator().manual_seed(STACK_V2_SEED)).state_dict()}
    registry = ModelRegistry(reg_dir)
    for version, state in states.items():
        path = os.path.join(reg_dir, f"mnist_{version}.pt")
        save_state_dict(model_state_dict(state), path)
        registry.publish("mnist", version, path)
    registry = ModelRegistry(reg_dir)  # a fresh reader of the manifest
    entry = registry.resolve()
    check((entry.model, entry.version) == ("mnist", "v1"), f"default route {entry.describe()}")

    tel_dir = os.path.join(workdir, "telemetry")
    sink = open_sink(tel_dir)
    metrics = ServingMetrics()
    engine = InferenceEngine(registry.load(entry), version=entry.version, dtypes=("bf16", "int8"),
                             int8_impl="pallas", packed=True, metrics=metrics)
    check(engine.device.type == "cuda", f"stack engine on {engine.device}")
    dev = engine.device
    with span("warmup", sink=sink, registry=metrics.registry):
        rungs = engine.warmup()
    gates = engine.verify_parity(sink=sink)
    check(all(g["passed"] for g in gates.values()) and set(gates) == {"bf16", "int8"},
          f"(a) parity gates {gates}")
    warm_launches = ih.LAUNCHES  # one int8 rung and the int8 gate

    # References, computed before any server thread owns the dispatch.
    raw = np.random.RandomState(PARITY_SEED + 14).randint(0, 256, (256, 28, 28)).astype(np.uint8)
    x = decode_instances({"instances": raw.tolist()})  # the server's model input
    with reference():
        ref = {dt: engine.predict_logits(x, dtype=dt) for dt in ("f32", "bf16", "int8")}
        engine.install_version("v2", registry.load(registry.resolve(version="v2")))
        ref_v2 = engine.predict_logits(x, dtype="f32@v2")
        engine.remove_version("v2")
        split_rows = x[100:160]
        unsplit = {dt: engine.predict_logits(split_rows, dtype=dt) for dt in ("f32", "int8")}
    check(float(np.abs(ref_v2 - ref["f32"]).max()) > 1e-2, "v1 and v2 answer alike")

    # (g) a packed request split across two batches, through the batcher:
    # 100 rows, then 60 that overflow the 128-row buffer by 32, per dtype.
    batches0 = metrics.batches
    batcher = MicroBatcher(engine, metrics=ServingMetrics(), linger_ms=5.0,
                           adaptive_linger=False, timeout_ms=STACK_TIMEOUT_MS)
    pending = {dt: (batcher.submit(x[:100], dtype=dt), batcher.submit(split_rows, dtype=dt))
               for dt in ("f32", "int8")}
    batcher.start()
    split_equal = {}
    for dt, (_, req) in pending.items():
        got = req.result()
        split_equal[dt] = bool(np.array_equal(got, unsplit[dt]))
    batcher.stop(drain=True)
    split_batches = metrics.batches - batches0
    check(split_batches == 4, f"(g) {split_batches} batches, want 4")
    check(all(split_equal.values()), f"(g) split answers differ from unsplit: {split_equal}")
    split_launches = ih.LAUNCHES - warm_launches - refs["launches"]
    check(split_launches == 2, f"(g) int8 split batches launched row 1 {split_launches} times")

    # (b) --int8-impl dot against pallas: engines and heads
    before = ih.LAUNCHES
    dot = InferenceEngine(registry.load(entry), dtypes=("int8",), int8_impl="dot", packed=True)
    dot.warmup()
    dot_gate = dot.verify_parity()["int8"]
    out_dot = dot.predict_logits(x[:128], dtype="int8")
    q = qparams_to(quantize_params(states["v1"]), dev)
    with torch.inference_mode():
        feats = conv_stack(q, torch.from_numpy(x[:128]).to(dev))
        head_dot = int8_head_dot(q["fc1"], q["fc2"], feats)
    dot_head_ms = median_ms(torch, lambda: int8_head_dot(q["fc1"], q["fc2"], feats))
    check(ih.LAUNCHES == before, f"(b) the dot engine launched row 1 {ih.LAUNCHES - before} times")
    with reference():
        head_kernel = ih.fused_int8_head(q["fc1"], q["fc2"], feats)
        kernel_head_ms = median_ms(torch, lambda: ih.fused_int8_head(q["fc1"], q["fc2"], feats))
    dot_err = float(np.abs(out_dot - ref["int8"][:128]).max())
    check(dot_gate["passed"], f"(b) dot gate {dot_gate}")
    check(torch.equal(head_dot, head_kernel), "(b) dot head != kernel head")
    check(dot_err <= DOT_TOL, f"(b) dot log-probs off pallas by {dot_err}")
    del dot

    rollout = RolloutController(registry, engine, metrics=metrics, sink=sink)
    server = make_server(engine, metrics, sink=sink, response_cache=STACK_CACHE,
                         rollout=rollout, queue_depth=STACK_QUEUE_DEPTH,
                         timeout_ms=STACK_TIMEOUT_MS, linger_ms=2.0, fill_wait_ms=2.0)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    predict = url + "/predict"
    out: dict = {}
    try:
        # (a) every variant over JSON against predict_logits
        a_err = {}
        for dt in ("f32", "bf16", "int8"):
            status, body, _ = http_post(predict, predict_body(raw[160:168], dt))
            check(status == 200, f"(a) /predict {dt} answered {status}")
            got = log_probs(body)
            a_err[dt] = float(np.abs(got - ref[dt][160:168]).max())
            check(a_err[dt] <= HTTP_TOL, f"(a) /predict {dt} off predict_logits by {a_err[dt]}")
            check((got.argmax(1) == ref[dt][160:168].argmax(1)).all(), f"(a) {dt} argmax")
        out["a_max_abs_vs_predict_logits"] = a_err

        # (c) the binary wire, then the same rows over JSON (a cache hit)
        rows = raw[170:174]
        status, body, ctype = http_post(predict, wire.encode_request(rows.astype(np.float32)),
                                        wire.WIRE_REQUEST_TYPE)
        check(status == 200 and ctype == wire.WIRE_RESPONSE_TYPE, f"(c) wire {status} {ctype}")
        binary = np.array(wire.decode_response(body))
        status, body, _ = http_post(predict, predict_body(rows))
        check(status == 200, f"(c) json {status}")
        check(binary.tobytes() == log_probs(body).tobytes(), "(c) wire bytes != JSON logits")
        check(binary.tobytes() == ref["f32"][170:174].tobytes(), "(c) wire != predict_logits")
        out["c_wire"] = metrics.snapshot()["wire"]

        # (d) concurrent identical requests: one dispatch; a repeat: a hit
        body_d = predict_body(raw[180:181], "int8")
        barrier = threading.Barrier(STACK_FLIGHT)

        def flight(_):
            barrier.wait()
            return http_post(predict, body_d)

        b0, l0, c0 = metrics.batches, ih.LAUNCHES, dict(metrics.snapshot()["cache"])
        with ThreadPoolExecutor(STACK_FLIGHT) as pool:
            answers = list(pool.map(flight, range(STACK_FLIGHT)))
        check(all(s == 200 for s, _, _ in answers), "(d) a coalesced request failed")
        check(len({b for _, b, _ in answers}) == 1, "(d) coalesced answers differ")
        d_batches, d_launches = metrics.batches - b0, ih.LAUNCHES - l0
        check(d_batches == 1 and d_launches == 1,
              f"(d) {STACK_FLIGHT} identical requests: {d_batches} batches, {d_launches} launches")
        b0, l0 = metrics.batches, ih.LAUNCHES
        status, body_hit, _ = http_post(predict, body_d)
        c1 = metrics.snapshot()["cache"]
        check(status == 200 and body_hit == answers[0][1], "(d) the repeat differs")
        check(metrics.batches == b0 and ih.LAUNCHES == l0, "(d) the repeat dispatched")
        out["d_single_flight"] = {
            "requests": STACK_FLIGHT, "batches": d_batches, "launches": d_launches,
            "cache_delta": {k: c1[k] - c0.get(k, 0) for k in ("hit", "miss", "coalesced")}}

        # (h) faults at launch and complete fail only their batch
        h = {}
        for spec, dt, lo in (("fail:launch", "f32", 190), ("fail:complete", "int8", 192)):
            failed0 = metrics.failed
            injector = faults.install(faults.FaultInjector(spec).start())
            try:
                status_fault, _, _ = http_post(predict, predict_body(raw[lo:lo + 2], dt))
            finally:
                faults.uninstall()
            status_after, body, _ = http_post(predict, predict_body(raw[lo:lo + 2], dt))
            check(injector.fired_counts() == {spec: 1}, f"(h) {spec} fired {injector.fired_counts()}")
            check(status_fault == 500 and metrics.failed - failed0 == 1,
                  f"(h) {spec}: {status_fault}, failed {metrics.failed - failed0}")
            check(status_after == 200 and np.abs(log_probs(body) - ref[dt][lo:lo + 2]).max()
                  <= HTTP_TOL, f"(h) {spec}: the server did not recover ({status_after})")
            h[spec] = {"fault": status_fault, "after": status_after}
        out["h_faults"] = h

        # (e) shedding under a batch backlog: the dispatch hangs at launch
        # while batch-class requests fill the queue, then interactive ones
        # arrive; then a reading round of both classes
        fresh = np.random.RandomState(PARITY_SEED + 15).randint(
            0, 256, (1 + STACK_SHED_BATCH + STACK_SHED_INTERACTIVE, 28, 28)).astype(np.uint8)
        injector = faults.install(faults.FaultInjector("hang:launch:for=10").start())
        try:
            rej0 = metrics.rejected
            shed0 = metrics.snapshot()["qos"]
            with ThreadPoolExecutor(1 + STACK_SHED_BATCH + STACK_SHED_INTERACTIVE) as pool:
                held = pool.submit(http_post, predict, predict_body(fresh[:1], qos="batch"))
                poll(lambda: injector.fired_counts()["hang:launch:for=10"] == 1, "the hang")
                batch = [pool.submit(http_post, predict, predict_body(fresh[1 + i:2 + i],
                                                                      qos="batch"))
                         for i in range(STACK_SHED_BATCH)]
                poll(lambda: server.batcher.depth() == STACK_QUEUE_DEPTH
                     and metrics.rejected - rej0 == STACK_SHED_BATCH - STACK_QUEUE_DEPTH,
                     "a full queue of batch requests")
                inter = [pool.submit(http_post, predict,
                                     predict_body(fresh[1 + STACK_SHED_BATCH + i:][:1],
                                                  qos="interactive"))
                         for i in range(STACK_SHED_INTERACTIVE)]
                poll(lambda: metrics.snapshot()["qos"]["batch"]["shed"]
                     - shed0["batch"]["shed"] == STACK_SHED_INTERACTIVE, "the sheds")
                faults.uninstall()  # wakes the hang
                statuses = {"held": held.result()[0],
                            "batch": [f.result()[0] for f in batch],
                            "interactive": [f.result()[0] for f in inter]}
        finally:
            faults.uninstall()
        qos = metrics.snapshot()["qos"]
        shed = {c: qos[c]["shed"] - shed0[c]["shed"] for c in qos}
        check(statuses["held"] == 200 and all(s == 200 for s in statuses["interactive"]),
              f"(e) {statuses}")
        check(shed == {"batch": STACK_SHED_INTERACTIVE, "interactive": 0}, f"(e) shed {shed}")
        check(statuses["batch"].count(503) == STACK_SHED_BATCH - STACK_QUEUE_DEPTH
              + STACK_SHED_INTERACTIVE, f"(e) batch statuses {statuses['batch']}")

        def qos_client(c: int, cls: str, n_rows: int) -> list[float]:
            rs = np.random.RandomState(1000 + c)
            lat = []
            for _ in range(STACK_QOS_REQUESTS):
                data = predict_body(rs.randint(0, 256, (n_rows, 28, 28)), qos=cls)
                t0 = time.perf_counter()
                status, _, _ = http_post(predict, data)
                lat.append(1e3 * (time.perf_counter() - t0))
                check(status == 200, f"(e) {cls} request answered {status}")
            return lat

        clients = ([("batch", STACK_QOS_BATCH_ROWS)] * STACK_QOS_BATCH_CLIENTS
                   + [("interactive", 1)] * STACK_QOS_INTERACTIVE_CLIENTS)
        with ThreadPoolExecutor(len(clients)) as pool:
            lats = list(pool.map(lambda c: qos_client(c, *clients[c]), range(len(clients))))
        by_class = {cls: [t for (c, _), lat in zip(clients, lats) if c == cls for t in lat]
                    for cls in ("interactive", "batch")}
        qos = metrics.snapshot()["qos"]
        out["e_qos"] = {
            "shed_check": {"statuses_503": {k: v.count(503) for k, v in statuses.items()
                                            if isinstance(v, list)}, "shed": shed},
            "client_ms": {cls: {"requests": len(v), "p50": float(np.percentile(v, 50)),
                                "p99": float(np.percentile(v, 99))}
                          for cls, v in by_class.items()},
            "server_ms_whole_phase": {cls: {k: qos[cls][k] for k in ("requests", "p50_ms",
                                                                      "p99_ms")}
                                      for cls in qos}}

        # (f) the canary at 25%, rollback, then a swap under load
        status, body, _ = http_post(url + "/admin/canary", json.dumps(
            {"version": "v2", "pct": STACK_CANARY_PCT}).encode())
        check(status == 200, f"(f) canary start {status}: {body[:200]}")
        picked = [canary_assignment(np.ascontiguousarray(x[i:i + 1]).data, STACK_CANARY_PCT)
                  for i in range(STACK_CANARY_ROWS)]
        wrong = []
        for i in range(STACK_CANARY_ROWS):
            status, body, _ = http_post(predict, predict_body(raw[i:i + 1]))
            want = ref_v2[i:i + 1] if picked[i] else ref["f32"][i:i + 1]
            if status != 200 or log_probs(body).tobytes() != want.tobytes():
                wrong.append(i)
        check(not wrong and 0 < sum(picked) < STACK_CANARY_ROWS,
              f"(f) canary rows off their assignment: {wrong} ({sum(picked)} picked)")
        status, _, _ = http_post(url + "/admin/rollback", b"{}")
        check(status == 200, f"(f) rollback {status}")
        restored = all(log_probs(http_post(predict, predict_body(raw[i:i + 1]))[1]).tobytes()
                       == ref["f32"][i:i + 1].tobytes() for i in range(STACK_CANARY_ROWS)
                       if picked[i])
        check(restored, "(f) rollback did not restore v1")
        out["f_canary"] = {"rows": STACK_CANARY_ROWS, "pct": STACK_CANARY_PCT,
                           "picked": int(sum(picked)), "restored_v1": restored}

        done = {"n": 0}
        lock = threading.Lock()

        def swap_client(c: int) -> list[tuple[int, int, bytes]]:
            got = []
            for j in range(STACK_SWAP_PER_CLIENT):
                i = 64 + (c * STACK_SWAP_PER_CLIENT + j) % 192
                status, body, _ = http_post(predict, predict_body(raw[i:i + 1]))
                got.append((i, status, body))
                with lock:
                    done["n"] += 1
            return got

        total = STACK_SWAP_CLIENTS * STACK_SWAP_PER_CLIENT
        with ThreadPoolExecutor(STACK_SWAP_CLIENTS) as pool:
            futures = [pool.submit(swap_client, c) for c in range(STACK_SWAP_CLIENTS)]
            poll(lambda: done["n"] >= total // 4, "a quarter of the swap traffic")
            t0 = time.perf_counter()
            status, body, _ = http_post(url + "/admin/swap", b'{"version": "v2"}')
            swap_s = time.perf_counter() - t0
            results = [r for f in futures for r in f.result()]
        check(status == 200, f"(f) swap {status}: {body[:200]}")
        dropped = sum(1 for _, s, _ in results if s != 200)
        served = {"v1": 0, "v2": 0, "torn": 0}
        for i, s, body in results:
            if s != 200:
                continue
            got = log_probs(body).tobytes()
            served["v1" if got == ref["f32"][i:i + 1].tobytes() else
                   "v2" if got == ref_v2[i:i + 1].tobytes() else "torn"] += 1
        check(dropped == 0 and served["torn"] == 0 and served["v1"] > 0 and served["v2"] > 0,
              f"(f) swap under load: dropped {dropped}, served {served}")
        after = log_probs(http_post(predict, predict_body(raw[64:65]))[1])
        check(after.tobytes() == ref_v2[64:65].tobytes(), "(f) after the swap v1 still serves")
        check(registry.resolve().version == "v2", "(f) the manifest's default did not move")
        # (d) the swap invalidated the cache: the repeat misses and dispatches
        m0, l0 = metrics.snapshot()["cache"]["miss"], ih.LAUNCHES
        status, body_after, _ = http_post(predict, body_d)
        check(status == 200 and metrics.snapshot()["cache"]["miss"] == m0 + 1
              and ih.LAUNCHES == l0 + 1 and body_after != body_hit,
              "(d) the swap left the cache entry")
        out["f_swap"] = {"requests": total, "swap_s": swap_s, "dropped": dropped,
                         "served": served}
        snap = metrics.snapshot()
        out["cache"] = snap["cache"]
        out["hit_ratio"] = snap["cache"]["hit_rate"]
        check("serving_qos_requests_total" in get(url + "/metrics?format=prom").decode(),
              "the qos family on /metrics")
        out["healthz_rollout"] = json.loads(get(url + "/healthz"))["rollout"]
    finally:
        faults.uninstall()
        server.shutdown()
        server.batcher.stop(drain=True)
        server.server_close()
        serve.join(timeout=30)
        sink.close()
    check(not serve.is_alive(), "the stack server thread did not stop")
    events = read_events(sink.path)
    int8_batches = sum(1 for e in events if e["event"] == "serving_batch"
                       and e["dtype"].split("@")[0] == "int8")
    path = ih.LAUNCHES - refs["launches"]
    check(path == warm_launches + split_launches + int8_batches,
          f"row 1 launched {path} times on the path, want {warm_launches} (warmup, gate) + "
          f"{split_launches} (split) + {int8_batches} (int8 batches served)")
    check(any(e["event"] == "span_end" and e["span"] == "warmup" for e in events),
          "no warmup span in the telemetry")

    # (i) a --syncbn archive at f32 and bf16; int8 refused
    bn_model = bn_net(torch, STACK_BN_SEED)
    bn_path = os.path.join(workdir, "mnist_cnn_syncbn.pt")
    save_state_dict(model_state_dict(bn_model, ddp_prefix=True, num_batches=9), bn_path)
    bn_engine = InferenceEngine.from_checkpoint(bn_path, dtypes=("bf16",), packed=True)
    bn_engine.warmup()
    bn_gate = bn_engine.verify_parity()["bf16"]
    check(bn_gate["passed"], f"(i) BN bf16 gate {bn_gate}")
    bn_metrics = ServingMetrics()
    bn_server = make_server(bn_engine, bn_metrics, linger_ms=1.0)
    bn_serve = threading.Thread(target=bn_server.serve_forever, daemon=True)
    bn_serve.start()
    try:
        bn_url = f"http://127.0.0.1:{bn_server.server_address[1]}/predict"
        bn_out = {}
        for dt in ("f32", "bf16"):
            status, body, _ = http_post(bn_url, predict_body(raw[:16], dt))
            check(status == 200, f"(i) BN /predict {dt} answered {status}")
            bn_out[dt] = log_probs(body)
    finally:
        bn_server.shutdown()
        bn_server.batcher.stop(drain=True)
        bn_server.server_close()
        bn_serve.join(timeout=30)
    with torch.inference_mode():
        bn_ref = bn_model.eval()(torch.from_numpy(x[:16])).numpy()
    bn_err = {dt: float(np.abs(v - bn_ref).max()) for dt, v in bn_out.items()}
    check(bn_err["f32"] <= F32_TOL, f"(i) BN f32 off the CPU model by {bn_err['f32']}")
    check((bn_out["bf16"].argmax(1) == bn_ref.argmax(1)).all(), "(i) BN bf16 argmax")
    try:
        InferenceEngine.from_checkpoint(bn_path, dtypes=("int8",))
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("serve BN checkpoints at f32 or bf16" in refused, f"(i) int8 not refused: {refused!r}")
    out["i_batchnorm"] = {"bf16_gate": bn_gate, "max_abs_vs_cpu_model": bn_err,
                          "int8_refusal": refused}

    emit({"phase": "serving_stack", "registry": registry.describe()["models"]["mnist"],
          "rungs": len(rungs), "gates": gates, "split": {"batches": split_batches,
                                                          "equal_bit_for_bit": split_equal},
          "dot_vs_pallas": {"gate": dot_gate, "max_abs_log_probs": dot_err,
                            "head_equal": True, "dot_head_ms": dot_head_ms,
                            "kernel_head_ms": kernel_head_ms, "rows": 128},
          **out, "int8_batches_served": int8_batches,
          "launches": {"int8_head": path, "reference": refs["launches"]},
          "seconds": time.perf_counter() - t_phase})
    return {"int8_head": path}, {"int8_head": refs["launches"]}


def pool_clients(url: str, ref: dict, n_clients: int, per_client: int, seed: int,
                 dtypes=("f32", "int8"), progress=None, allow_503: bool = False,
                 stop=None) -> dict:
    """``n_clients`` closed-loop JSON clients, ``per_client`` requests each
    of 1..12 rows of the phase's rows (dtypes in turn); every answer held
    to ``ref`` within HTTP_TOL with the same argmax.  Where ``ref`` has
    ``by_bucket`` ({dtype: {bucket: every row's log-probs staged at that
    bucket}}), an answer is held to the bucket of those that can carry its
    rows whose log-probs it is nearest: a coalesced batch runs at a bucket
    the client cannot see.  With ``allow_503`` a 503 is an outcome too
    (every retry of the request met a failing replica).  A set ``stop``
    event ends each client before its next request.  Returns the request
    ids answered, the client latencies, the 503s, the failures, the
    largest error per dtype and, with ``by_bucket``, the requests per
    bucket held to."""
    import collections

    import numpy as np

    raw = ref["raw"]
    lock = threading.Lock()
    answered, latencies, bad, rejected = [], [], [], []
    worst = {dt: 0.0 for dt in dtypes}
    held_at = collections.Counter()

    def client(c: int) -> None:
        for j in range(per_client):
            if stop is not None and stop.is_set():
                return
            size = 1 + (c + j + seed) % 12
            off = (7 * c + 13 * j + seed) % (len(raw) - size)
            dtype = dtypes[(c + j) % len(dtypes)]
            t0 = time.perf_counter()
            status, body, _ = http_post(url + "/predict", predict_body(raw[off:off + size], dtype))
            ms = 1e3 * (time.perf_counter() - t0)
            ok, err, bucket = status == 200, None, None
            if ok:
                got = log_probs(body)
                wants = ({b: a[off:off + size] for b, a in ref["by_bucket"][dtype].items()
                          if b >= size} if "by_bucket" in ref
                         else {None: ref[dtype][off:off + size]})
                fits = {b: w for b, w in wants.items() if w.shape == got.shape}
                ok = bool(fits)
                if ok:
                    err, bucket = min((float(np.abs(got - w).max()), b) for b, w in fits.items())
                    ok = err <= HTTP_TOL and bool((got.argmax(1) == fits[bucket].argmax(1)).all())
            with lock:
                answered.append((c, j))
                latencies.append(ms)
                if err is not None:
                    worst[dtype] = max(worst[dtype], err)
                if ok and bucket is not None:
                    held_at[bucket] += 1
                if status == 503 and allow_503:
                    rejected.append((c, j))
                elif not ok:
                    bad.append((c, j, status, dtype, err))
                n = len(answered)
            if progress is not None:
                progress(n)

    with ThreadPoolExecutor(n_clients) as pool:
        list(pool.map(client, range(n_clients)))
    return {"answered": answered, "latencies_ms": latencies, "bad": bad, "rejected": rejected,
            "max_abs_err": worst, "requests_by_bucket": dict(sorted(held_at.items()))}


def pool_phase(torch, np, workdir: str, device: str = "cuda") -> tuple[dict, dict]:
    """The replica pool on the card: two replicas of the full-width CNN
    sharing cuda:0, each on its own CUDA stream, --dtypes f32,int8
    --int8-impl pallas.  Checks (a)-(g) of the module docstring; readings
    of client latency with one and two replicas, of the two streams'
    overlap on the card and of row 1 alone and on two streams.  Returns
    row 1's launches on the path and, apart, those of the references.

    (a) runs a bucketed pool (the CLI's default) and a packed one from one
    client; the other concurrent checks run the packed pool, whose batch
    is always the 128-row buffer, so a row's answer does not depend on its
    batch-mates and one reference holds every answer within HTTP_TOL.  A
    coalesced bucketed batch has another size than a lone request's, cuDNN
    sums its f32 convs in another order, and int8 answers then move by
    flipped fc1 input codes (up to 7.2e-4 on the card against the 128-row
    reference).  So (b)'s bucketed round sends each request rows of its
    own, records the bucket and rows of every batch at its launch, and
    holds each answer to a single engine's on the same rows at that
    bucket."""
    import json as json_
    import os

    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.models.quant import conv_stack, qparams_to, quantize_params
    from pytorch_mnist_ddp_tpu_torch.obs.events import open_sink, read_events
    from pytorch_mnist_ddp_tpu_torch.ops import _build
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
    from pytorch_mnist_ddp_tpu_torch.serving import faults
    from pytorch_mnist_ddp_tpu_torch.serving.batcher import RejectedError
    from pytorch_mnist_ddp_tpu_torch.serving.engine import PARITY_SEED, InferenceEngine
    from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
    from pytorch_mnist_ddp_tpu_torch.serving.pool import EnginePool
    from pytorch_mnist_ddp_tpu_torch.serving.registry import ModelRegistry
    from pytorch_mnist_ddp_tpu_torch.serving.rollout import RolloutController
    from pytorch_mnist_ddp_tpu_torch.serving.router import POLICIES, ShardedRequest
    from pytorch_mnist_ddp_tpu_torch.serving.server import decode_instances, make_server
    from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import model_state_dict, save_state_dict

    t_phase = time.perf_counter()
    refs = {"launches": 0}

    @contextlib.contextmanager
    def reference():
        before = ih.LAUNCHES
        try:
            yield
        finally:
            refs["launches"] += ih.LAUNCHES - before

    reg_dir = os.path.join(workdir, "pool_registry")
    os.makedirs(reg_dir)
    for version, seed in (("v1", SEED), ("v2", STACK_V2_SEED)):
        path = os.path.join(reg_dir, f"mnist_{version}.pt")
        save_state_dict(model_state_dict(Net(torch.Generator().manual_seed(seed)).state_dict()),
                        path)
        ModelRegistry(reg_dir).publish("mnist", version, path)
    registry = ModelRegistry(reg_dir)
    entry = registry.resolve()
    v1, v2 = registry.load(entry), registry.load(registry.resolve(version="v2"))

    sink = open_sink(os.path.join(workdir, "pool_telemetry"))
    metrics = ServingMetrics()
    kw = dict(replicas=POOL_REPLICAS, device=device, dtypes=("int8",), int8_impl="pallas")
    bucketed = EnginePool(v1, version=entry.version, metrics=ServingMetrics(),
                          buckets=POOL_BUCKETED_LADDER, **kw)
    pool = EnginePool(v1, version=entry.version, packed=True, metrics=metrics, **kw)
    streams = [e.stream for e in pool.engines]
    if device == "cuda":
        check(pool.devices == [torch.device("cuda", 0)] * POOL_REPLICAS,
              f"replicas on {pool.devices}, want both on cuda:0")
        default = torch.cuda.default_stream(pool.devices[0])
        check(len({s.cuda_stream for s in streams} | {default.cuda_stream})
              == POOL_REPLICAS + 1, "the replicas do not each own a stream")
    t0 = time.perf_counter()
    pool.warmup()
    warm_s = time.perf_counter() - t0
    bucketed.warmup()
    gates = pool.verify_parity(sink=sink)
    gates_bucketed = bucketed.verify_parity()
    check(set(gates) == {"int8"} and gates["int8"]["passed"]
          and gates_bucketed["int8"]["passed"], f"(a) pool gates {gates}, {gates_bucketed}")
    rungs, loads = pool.rungs_run(), _build.LOADS
    warm_launches = ih.LAUNCHES

    # References, before any batcher owns a replica's dispatch.
    raw = np.random.RandomState(PARITY_SEED + 16).randint(0, 256, (320, 28, 28)).astype(np.uint8)
    x = decode_instances({"instances": raw.tolist()})
    raw_b = np.random.RandomState(PARITY_SEED + 17).randint(
        0, 256, (POOL_BUCKETED_ROWS, 28, 28)).astype(np.uint8)
    xb = decode_instances({"instances": raw_b.tolist()})
    with reference():
        refs_by_mode, a_equal = {}, {}
        for mode, p in (("bucketed", bucketed), ("packed", pool)):
            single = InferenceEngine(v1, device=device, dtypes=("int8",), int8_impl="pallas",
                                     packed=mode == "packed", buckets=p.buckets)
            single.warmup()
            check(single.verify_parity()["int8"]["passed"], "(a) the single engine's gate")
            r = {"raw": raw, **{dt: single.predict_logits(x, dtype=dt) for dt in ("f32", "int8")}}
            refs_by_mode[mode] = r
            if mode == "bucketed":  # (b)'s bucketed round replays its batches on it
                single_bucketed = single
            a_equal.update({f"{mode} r{i}:{dt}": bool(np.array_equal(
                e.predict_logits(x[:128], dtype=dt), r[dt][:128]))
                for i, e in enumerate(p.engines) for dt in ("f32", "int8")})
            del single
        ref = refs_by_mode["packed"]
        ref_v2 = InferenceEngine(v2, device=device, packed=True).predict_logits(x)
    check(all(a_equal.values()), f"(a) a replica's predict_logits differs from the "
          f"single engine's: {a_equal}")
    check(float(np.abs(ref_v2 - ref["f32"]).max()) > 1e-2, "v1 and v2 answer alike")

    # Every int8 dispatch a replica's engine takes on the path: the count
    # row 1's launches must equal.  (The telemetry's serving_batch events
    # miss a batch the supervisor's abort caught between its launch and
    # its read-back, whose requests were retried elsewhere.)
    int8_dispatches = {"n": 0}
    count_lock = threading.Lock()

    def count_int8_dispatches(engine) -> None:
        launch = engine.launch

        def counted(staged, n, dtype=None, seg_ids=None):
            result = launch(staged, n, dtype=dtype, seg_ids=seg_ids)
            if (dtype or "f32").split("@")[0] == "int8":
                with count_lock:
                    int8_dispatches["n"] += 1
            return result

        engine.launch = counted

    # (b) bucketed: the bucket, dtype and rows of every batch launched
    launched: dict = {"log": None}

    def record_launches(engine) -> None:
        launch = engine.launch

        def recorded(staged, n, dtype=None, seg_ids=None):
            if launched["log"] is not None:
                rows = [r.tobytes() for r in staged[:n].numpy()]
                with count_lock:
                    launched["log"].append((len(staged), (dtype or "f32").split("@")[0], rows))
            return launch(staged, n, dtype=dtype, seg_ids=seg_ids)

        engine.launch = recorded

    for engine in pool.engines + bucketed.engines:
        count_int8_dispatches(engine)
    for engine in bucketed.engines:
        record_launches(engine)
    path_start, refs_start = ih.LAUNCHES, refs["launches"]
    batcher_kwargs = dict(linger_ms=1.0, timeout_ms=POOL_TIMEOUT_MS)
    out: dict = {}

    @contextlib.contextmanager
    def serving(policy: str = "cost", p=None, rollout=None, response_cache=None, **start):
        p = p if p is not None else pool
        router = p.start(router_policy=policy, sink=sink, **{**batcher_kwargs, **start})
        server = make_server(p, p.metrics, batcher=router, sink=sink, rollout=rollout,
                             response_cache=response_cache)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            yield router, f"http://127.0.0.1:{server.server_address[1]}"
        finally:
            faults.uninstall()
            server.shutdown()
            p.stop()
            server.server_close()
            thread.join(timeout=30)
            check(not thread.is_alive(), "a pool server thread did not stop")

    def decisions(policy: str, p=None) -> dict:
        p = p if p is not None else pool
        return {name: p.metrics.registry.counter("serving_router_decisions_total",
                                                 policy=policy, replica=name).value
                for name in p.replica_names}

    try:
        # (a) over HTTP, one client: each dtype within HTTP_TOL of
        # predict_logits, the bucketed pool and the packed one
        out["a_http_max_abs_err"] = {}
        for mode, p in (("bucketed", bucketed), ("packed", pool)):
            with serving("roundrobin", p=p, supervise=False) as (_, url):
                run = pool_clients(url, refs_by_mode[mode], 1, 8, seed=0)
            check(not run["bad"], f"(a) {mode} /predict answers off: {run['bad']}")
            out["a_http_max_abs_err"][mode] = run["max_abs_err"]

        # (b) each policy under POOL_CLIENTS closed-loop clients; (c) under
        # cost, r1 drained at a quarter of the traffic and added back at half
        b = {}
        for policy in POLICIES:
            total = POOL_CLIENTS * POOL_PER_CLIENT
            done0, d0 = metrics.completed, decisions(policy)
            drain: dict = {}
            with serving(policy) as (_, url):
                def progress(n, policy=policy):
                    if policy != "cost":
                        return
                    if n == total // 4 and "s" not in drain:
                        drain["s"] = pool.drain("r1")
                    elif n == total // 2 and "add" not in drain:
                        t0 = time.perf_counter()
                        pool.add("r1")
                        drain["add"] = time.perf_counter() - t0

                t0 = time.perf_counter()
                run = pool_clients(url, ref, POOL_CLIENTS, POOL_PER_CLIENT, seed=1,
                                   progress=progress)
                secs = time.perf_counter() - t0
            d = {name: n - d0[name] for name, n in decisions(policy).items()}
            ids = run["answered"]
            check(not run["bad"] and len(ids) == total and len(set(ids)) == total,
                  f"(b) {policy}: {len(ids)} answers for {total}, bad {run['bad'][:5]}")
            check(sum(d.values()) == total and metrics.completed - done0 == total,
                  f"(b) {policy}: decisions {d}, completed {metrics.completed - done0} of {total}")
            b[policy] = {"requests": total, "decisions": d, "seconds": secs,
                         "max_abs_err": run["max_abs_err"],
                         "client_p50_ms": float(np.percentile(run["latencies_ms"], 50)),
                         "client_p99_ms": float(np.percentile(run["latencies_ms"], 99))}
            if policy == "cost":
                check("s" in drain and "add" in drain, f"(c) drain/add did not run: {drain}")
                check(pool.rungs_run() == rungs and _build.LOADS == loads,
                      f"(c) the add ran {pool.rungs_run() - rungs} rungs, "
                      f"loaded {_build.LOADS - loads} libraries")
                out["c_drain_add"] = {"drain_s": drain["s"], "add_s": drain["add"],
                                      "rungs_added": pool.rungs_run() - rungs,
                                      "libraries_loaded": _build.LOADS - loads}
        out["b_policies"] = b
        out["b_bucketed"] = bucketed_round(bucketed, single_bucketed, reference, xb, raw_b,
                                           launched, sink, serving, decisions)
        del bucketed, single_bucketed

        # (d) the supervisor: r1 killed at launch -> quarantined, restarted,
        # half-open, closed; then a schedule past its restart budget
        sup_kwargs = dict(interval_s=0.02, backoff_base_s=0.05, backoff_max_s=0.5,
                          restart_budget=3)
        retried0, done0 = metrics.retried, metrics.completed
        with serving("roundrobin", supervisor_kwargs=sup_kwargs) as (router, url):
            with faults.injected(f"fail:launch:r1:count={POOL_KILLED_LAUNCHES}") as injector:
                run = pool_clients(url, ref, POOL_CLIENTS, POOL_SUPERVISOR_PER_CLIENT, seed=2,
                                   allow_503=True)
            fired = injector.fired_counts()
            closes = 0
            deadline = time.perf_counter() + 20
            while not (router.replica("r1").active
                       and router.replica("r1").breaker.state == "closed"):
                check(time.perf_counter() < deadline, "(d) r1 did not come back closed")
                closes += len(pool_clients(url, ref, 2, 2, seed=3)["answered"])
                time.sleep(0.02)
            stats = pool.supervisor.stats()
        total = POOL_CLIENTS * POOL_SUPERVISOR_PER_CLIENT
        # A 503 is a request whose 1 + replicas attempts all met r1's faults
        # (the server's retry budget, JAX's): three faults each.
        rejected = len(run["rejected"])
        check(not run["bad"] and len(run["answered"]) == total
              and rejected <= sum(fired.values()) // 3, f"(d) {run['bad'][:5]}, {rejected} 503s")
        check(metrics.completed - done0 == total - rejected + closes,
              "(d) a request completed twice or never")
        check(stats["replicas"]["r1"]["restarts"] >= 1, f"(d) no restart: {stats}")
        check(pool.rungs_run() == rungs and _build.LOADS == loads,
              "(d) the restart ran a warmup rung or loaded a library")
        r1_moves = [(e["src"], e["dst"]) for e in read_events(sink.path)
                    if e["event"] == "circuit_transition" and e["replica"] == "r1"]
        check(("closed", "open") in r1_moves and ("open", "half-open") in r1_moves
              and ("half-open", "closed") in r1_moves, f"(d) r1's circuit moves {r1_moves}")
        out["d_supervisor"] = {"fired": fired, "requests": total, "503": rejected,
                               "restarts": stats["replicas"]["r1"]["restarts"],
                               "recovery_s": stats["replicas"]["r1"]["recovery_s"],
                               "retries": metrics.retried - retried0,
                               "circuit_moves": r1_moves}
        with serving("roundrobin", supervisor_kwargs={**sup_kwargs, "restart_budget": 1}) \
                as (router, url):
            with faults.injected("fail:launch:r1:count=inf"):
                deadline = time.perf_counter() + 20
                sent = rejected = 0
                while router.replica("r1").state != "ejected":
                    check(time.perf_counter() < deadline, "(d) r1 was not ejected")
                    run = pool_clients(url, ref, 4, 2, seed=4, allow_503=True)
                    check(not run["bad"], f"(d) ejection schedule: {run['bad']}")
                    sent += len(run["answered"])
                    rejected += len(run["rejected"])
                run = pool_clients(url, ref, 4, 2, seed=5)
            check(not run["bad"] and router.routable_count() == 1, "(d) after the ejection")
            status, body, _ = http_post(url + "/predict", predict_body(raw[:1]))
        out["d_ejection"] = {"requests_until_ejected": sent, "503": rejected,
                             "served_after": status}

        # (e) hedging: r0's read-back hangs, the hedge on r1 wins
        h0 = dict(metrics.snapshot().get("hedges", {}))
        with serving("roundrobin", supervise=False, hedge=True,
                     hedge_delay_ms=POOL_HEDGE_DELAY_MS) as (router, url):
            with faults.injected(f"hang:complete:r0:for={POOL_HANG_S}"):
                req = router.submit(x[:4], dtype="int8")  # rotation 0: r0
                got = req.result()
                by = req.completed_by
        h1 = metrics.snapshot()["hedges"]
        hedges = {k: h1[k] - h0.get(k, 0) for k in h1}
        dispatched = metrics.registry.counter("serving_hedge_dispatches_total",
                                              replica="r1").value
        check(by == "r1" and np.abs(got - ref["int8"][:4]).max() <= HTTP_TOL,
              f"(e) the hedge did not win: completed by {by}")
        check(hedges == {"won": 1, "lost": 0, "cancelled": 0} and dispatched == 1,
              f"(e) hedge counters {hedges}, dispatches {dispatched}")
        out["e_hedge"] = {"completed_by": by, "hedges": hedges, "dispatches_r1": dispatched}

        # (f) oversize: 256 rows (two replicas x the top bucket) split over
        # both, equal to the single engine's rows; 300 refused by capacity
        with serving("roundrobin", supervise=False) as (router, url):
            f = {}
            for dt in ("f32", "int8"):
                req = router.submit(x[:POOL_OVERSIZE_ROWS], dtype=dt)
                check(isinstance(req, ShardedRequest), "(f) not split")
                got = req.result()
                by = sorted(p.completed_by for p in req._parts)
                f[dt] = {"equal": bool(np.array_equal(got, ref[dt][:POOL_OVERSIZE_ROWS])),
                         "replicas": by}
            try:
                router.submit(x[:POOL_REFUSED_ROWS])
                refused = ""
            except RejectedError as e:
                refused = str(e)
            status, body, _ = http_post(url + "/predict", predict_body(raw[:POOL_OVERSIZE_ROWS]))
        check(all(v["equal"] and v["replicas"] == ["r0", "r1"] for v in f.values()),
              f"(f) oversize answers {f}")
        check("exceeds pool capacity" in refused, f"(f) {POOL_REFUSED_ROWS} rows: {refused!r}")
        check(status == 200 and np.abs(log_probs(body) - ref["f32"][:POOL_OVERSIZE_ROWS]).max()
              <= HTTP_TOL, f"(f) oversize over HTTP {status}")
        out["f_oversize"] = {**f, "refused_rows": POOL_REFUSED_ROWS, "refusal": refused}

        # (g) a swap to v2 under load; a cache hit and the dot head launch
        # nothing
        rollout = RolloutController(registry, pool, metrics=metrics, sink=sink)
        with serving("cost", rollout=rollout, response_cache=POOL_CACHE) as (router, url):
            body_hit = predict_body(raw[300:302], "int8")
            http_post(url + "/predict", body_hit)
            l0, c0 = ih.LAUNCHES, metrics.snapshot()["cache"]["hit"]
            status, _, _ = http_post(url + "/predict", body_hit)
            check(status == 200 and ih.LAUNCHES == l0
                  and metrics.snapshot()["cache"]["hit"] == c0 + 1, "(g) a cache hit launched")
            results, count = [], {"n": 0}
            lock = threading.Lock()

            def swap_client(c: int) -> None:
                for j in range(POOL_SWAP_PER_CLIENT):
                    i = (c * POOL_SWAP_PER_CLIENT + j) % 256
                    status, body, _ = http_post(url + "/predict", predict_body(raw[i:i + 1]))
                    with lock:
                        results.append((i, status, body))
                        count["n"] += 1

            total = POOL_CLIENTS * POOL_SWAP_PER_CLIENT
            with ThreadPoolExecutor(POOL_CLIENTS) as tp:
                futures = [tp.submit(swap_client, c) for c in range(POOL_CLIENTS)]
                poll(lambda: count["n"] >= total // 4, "a quarter of the swap traffic")
                status, body, _ = http_post(url + "/admin/swap", b'{"version": "v2"}')
                for fut in futures:
                    fut.result()
            check(status == 200, f"(g) swap {status}: {body[:200]}")
            served = {"v1": 0, "v2": 0, "torn": 0}
            dropped = 0
            for i, s, body in results:
                if s != 200:
                    dropped += 1
                    continue
                got = log_probs(body)
                close = {v: float(np.abs(got - r[i:i + 1]).max())
                         for v, r in (("v1", ref["f32"]), ("v2", ref_v2))}
                served[min(close, key=close.get) if min(close.values()) <= HTTP_TOL
                       else "torn"] += 1
            after = log_probs(http_post(url + "/predict", predict_body(raw[310:311]))[1])
        check(dropped == 0 and served["torn"] == 0 and served["v1"] > 0 and served["v2"] > 0,
              f"(g) swap under load: dropped {dropped}, served {served}")
        check(np.abs(after - ref_v2[310:311]).max() <= HTTP_TOL
              and all(e.version == "v2" for e in pool.engines), "(g) v2 does not serve")
        out["g_swap"] = {"requests": total, "dropped": dropped, "served": served}
        # back to v1 for the readings
        pool.publish_weights(v1, version="v1")

        # Readings: client latency with one and two replicas, the same
        # traffic; the two streams' overlap on the card
        readings = {}
        with reference():  # its warmup and gate are no served batches
            one = EnginePool(v1, replicas=1, device=device, dtypes=("int8",), packed=True,
                             int8_impl="pallas", metrics=ServingMetrics())
            one.warmup()
            check(one.verify_parity()["int8"]["passed"], "the one-replica pool's gate")
        count_int8_dispatches(one.engines[0])
        for n, p in ((1, one), (POOL_REPLICAS, pool)):
            with serving("cost", p=p) as (_, url):
                t0 = time.perf_counter()
                run = pool_clients(url, ref, POOL_CLIENTS, POOL_READ_PER_CLIENT, seed=6)
                secs = time.perf_counter() - t0
            check(not run["bad"], f"reading round with {n} replicas: {run['bad'][:5]}")
            lat = run["latencies_ms"]
            readings[f"replicas_{n}"] = {
                "requests": len(lat), "seconds": secs, "rps": len(lat) / secs,
                "max_abs_err": run["max_abs_err"],
                "client_p50_ms": float(np.percentile(lat, 50)),
                "client_p99_ms": float(np.percentile(lat, 99))}
        del one
        if device == "cuda":
            trace = os.path.join(workdir, "pool_trace.json")
            with serving("roundrobin", supervise=False) as (_, url):
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                        torch.profiler.ProfilerActivity.CUDA]) \
                        as prof:
                    pool_clients(url, ref, POOL_CLIENTS, 4, seed=7, dtypes=("int8",))
                prof.export_chrome_trace(trace)
            readings["overlap"] = stream_overlap(json_.load(open(trace)))
        out["readings"] = readings
    finally:
        faults.uninstall()
        pool.stop()
        sink.close()

    events = read_events(sink.path)
    int8_batches = {name: sum(1 for e in events if e["event"] == "serving_batch"
                              and e["dtype"].split("@")[0] == "int8" and e.get("replica") == name)
                    for name in pool.replica_names}
    path = ih.LAUNCHES - path_start - (refs["launches"] - refs_start)
    served = sum(int8_batches.values())
    aborts = sum(1 for e in events if e["event"] in ("replica_quarantine", "replica_eject"))
    check(path == int8_dispatches["n"] and path > 0,
          f"row 1 launched {path} times on the pool's path, want one per int8 dispatch "
          f"({int8_dispatches['n']})")
    # An abort can catch at most its window (2) and one racing dispatch.
    check(served <= path <= served + 3 * aborts,
          f"row 1 launched {path} times, the replicas served {int8_batches} int8 batches, "
          f"{aborts} aborts")
    check(all(int8_batches.values()), f"a replica served no int8 batch: {int8_batches}")

    # Row 1 at n = 128: one stream, then the two replicas' streams in turn
    # (a reading; launches counted as references)
    if device == "cuda":
        with reference():
            q = qparams_to(quantize_params(v1), pool.devices[0])
            with torch.inference_mode():
                feats = conv_stack(q, torch.from_numpy(x[:128]).to(pool.devices[0]))
            out["row1_us_n128"] = two_stream_head_us(torch, q, feats, streams)

    emit({"phase": "pool", "replicas": POOL_REPLICAS, "devices": [str(d) for d in pool.devices],
          "streams": [s.cuda_stream for s in streams] if device == "cuda" else None,
          "warmup_s": warm_s, "rungs": rungs, "gates": gates, "a_replicas_equal_single": a_equal,
          **out, "int8_batches_served": int8_batches, "int8_dispatches": int8_dispatches["n"],
          "aborts": aborts,
          "launches": {"int8_head": path, "warmup_and_gate": warm_launches,
                       "reference": refs["launches"]},
          "seconds": time.perf_counter() - t_phase})
    return {"int8_head": path}, {"int8_head": refs["launches"] + warm_launches}


def bucketed_round(bucketed, single, reference, xb, raw_b, launched: dict, sink, serving,
                   decisions) -> dict:
    """(b) on the bucketed pool: POOL_CLIENTS closed-loop clients under
    cost, each request 1..12 rows of its own.  Every batch's bucket, dtype
    and rows are recorded at its launch and replayed on ``single`` (a
    single engine on the same ladder, its launches counted as
    references), which stages them at the same bucket; a request must
    land whole in one batch, and its answer be within HTTP_TOL (same
    argmax) of the replay's rows.  The buckets launched must be those the
    round's serving_batch events name, and the decision counters must sum
    to the requests."""
    import collections

    import numpy as np

    from pytorch_mnist_ddp_tpu_torch.obs.events import read_events
    from pytorch_mnist_ddp_tpu_torch.serving.buckets import bucket_for

    plan, off = [], 0  # (client, j, first row, rows, dtype)
    for c in range(POOL_CLIENTS):
        for j in range(POOL_PER_CLIENT):
            size = 1 + (c + j) % 12
            plan.append((c, j, off, size, ("f32", "int8")[(c + j) % 2]))
            off += size
    check(off <= len(xb), f"(b) bucketed: {off} rows planned, {len(xb)} made")
    answers, lock = {}, threading.Lock()

    def client(c: int) -> None:
        for cc, j, first, size, dtype in plan:
            if cc != c:
                continue
            t0 = time.perf_counter()
            status, body, _ = http_post(url + "/predict", predict_body(raw_b[first:first + size],
                                                                        dtype))
            with lock:
                answers[(c, j)] = (status, body, 1e3 * (time.perf_counter() - t0))

    d0 = decisions("cost", bucketed)
    events0 = len(read_events(sink.path))
    launched["log"] = []
    try:
        with serving("cost", p=bucketed) as (_, url):
            with ThreadPoolExecutor(POOL_CLIENTS) as tp:
                list(tp.map(client, range(POOL_CLIENTS)))
    finally:
        log, launched["log"] = launched["log"], None
    d = {name: n - d0[name] for name, n in decisions("cost", bucketed).items()}
    index = {xb[i].tobytes(): i for i in range(len(xb))}
    served_at: dict = {}
    replayed: dict = {}  # (row, bucket, dtype) -> the single engine's log-probs
    with reference():
        for bucket, dtype, rows in log:
            idx = [index[key] for key in rows]
            check(bucket_for(len(idx), single.buckets) == bucket,
                  f"(b) bucketed: {len(idx)} rows launched at bucket {bucket}")
            for i, want in zip(idx, single.predict_logits(xb[idx], dtype=dtype)):
                served_at.setdefault(i, set()).add((bucket, dtype))
                replayed[(i, bucket, dtype)] = want
    bad, worst = [], {"f32": 0.0, "int8": 0.0}
    by_bucket = collections.Counter()
    for c, j, first, size, dtype in plan:
        status, body, _ = answers[(c, j)]
        where = set().union(*(served_at.get(i, set()) for i in range(first, first + size)))
        if status != 200 or len(where) != 1 or next(iter(where))[1] != dtype:
            bad.append((c, j, status, sorted(where)))
            continue
        bucket = next(iter(where))[0]
        by_bucket[bucket] += 1
        got = log_probs(body)
        want = np.stack([replayed[(i, bucket, dtype)] for i in range(first, first + size)])
        err = float(np.abs(got - want).max())
        worst[dtype] = max(worst[dtype], err)
        if err > HTTP_TOL or not (got.argmax(1) == want.argmax(1)).all():
            bad.append((c, j, bucket, dtype, err))
    events = [e for e in read_events(sink.path)[events0:] if e["event"] == "serving_batch"]
    launched_buckets = collections.Counter(bucket for bucket, _, _ in log)
    told_buckets = collections.Counter(e["bucket"] for e in events)
    total = len(plan)
    check(not bad, f"(b) bucketed: answers off their bucket's reference: {bad[:5]}")
    check(launched_buckets == told_buckets,
          f"(b) bucketed: launched buckets {dict(launched_buckets)}, the serving_batch events "
          f"say {dict(told_buckets)}")
    check(sum(d.values()) == total, f"(b) bucketed: decisions {d} for {total} requests")
    lat = [ms for _, _, ms in answers.values()]
    return {"requests": total, "decisions": d, "max_abs_err": worst,
            "requests_by_bucket": dict(sorted(by_bucket.items())),
            "batches_by_bucket": dict(sorted(launched_buckets.items())),
            "client_p50_ms": float(np.percentile(lat, 50)),
            "client_p99_ms": float(np.percentile(lat, 99))}


def sharded_phase(torch, np, smi: str, device: str = "cuda") -> dict:
    """Sharded replicas on one card (the module docstring's 5d): every
    pool of SHARDED_SPECS over ``[device] * k``, its gates, a closed-loop
    client's answers held to a single-device engine at their bucket, the
    CLI's refusal of a plan the card cannot hold, and the readings.  No
    kernel launches: the counters must not move."""
    import contextlib
    import io

    from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
    from pytorch_mnist_ddp_tpu_torch.serving import sharded
    from pytorch_mnist_ddp_tpu_torch.serving.__main__ import main as serve_main
    from pytorch_mnist_ddp_tpu_torch.serving.buckets import bucket_for
    from pytorch_mnist_ddp_tpu_torch.serving.devices import parse_replica_shapes
    from pytorch_mnist_ddp_tpu_torch.serving.engine import PARITY_SEED, InferenceEngine
    from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
    from pytorch_mnist_ddp_tpu_torch.serving.pool import EnginePool

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    counts = lambda: (ih.LAUNCHES, dict(af.LAUNCHES), dict(fa.LAUNCHES))  # noqa: E731
    before = counts()
    raw = np.random.RandomState(PARITY_SEED + 19).randint(0, 256, (256, 28, 28)).astype(np.uint8)
    rows = normalize(raw)
    single = InferenceEngine.from_seed(SEED, device=dev)  # the dp CNN engine
    single.warmup()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def ms_per_batch(fn) -> float:
        for _ in range(5):
            fn()
        times = []
        for _ in range(SHARDED_TIMED_RUNS):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    def margin(logp) -> float:
        top = np.sort(logp, axis=1)
        return float((top[:, -1] - top[:, -2]).min())

    def padded(x, bucket):
        out = np.zeros((bucket, *x.shape[1:]), np.float32)
        out[:len(x)] = x
        return out

    x128 = rows[:128]
    single_ms = ms_per_batch(lambda: single.launch(x128, 128).wait())
    out: dict = {}
    for spec in SHARDED_SPECS:
        need = sum(k for _, k in parse_replica_shapes(spec))
        metrics = ServingMetrics()
        t0 = time.perf_counter()
        pool = EnginePool.from_seed(SEED, replica_shapes=spec, devices=[dev] * need,
                                    metrics=metrics)
        pool.warmup()  # every sharded replica's gate; a failing one raises
        warm_s = time.perf_counter() - t0
        refs = {}
        for eng in pool.engines:
            if eng.shard_kind != "dp":
                refs[eng.shard_kind] = sharded.reference_fn(eng.shard_kind, eng._vit_cfg,
                                                            eng.pp_microbatches)
        router = pool.start(router_policy="cost", linger_ms=1.0)
        worst: dict = {}
        served: dict = {}
        answer_margin = math.inf
        try:
            for j in range(SHARDED_REQUESTS):
                n = 1 + j % 12
                off = (37 * j) % (len(rows) - n)
                x = rows[off:off + n]
                req = router.submit(x)
                got = np.asarray(req.result())
                name = req.completed_by
                eng = pool.engines[int(name[1:])]
                bucket = bucket_for(n, eng.buckets)
                xb = padded(x, bucket)
                if eng.shard_kind in ("dp", "tp"):
                    want = single.launch(xb, n).wait()[:n]
                else:
                    with eng.on_stream():
                        want = refs[eng.shard_kind](eng._host_served, torch.from_numpy(xb).to(
                            eng.device)).cpu().numpy()[:n]
                tol = sharded.SHARDED_PARITY_TOL.get(eng.shard_kind, 0.0)
                err = float(np.abs(got - want).max())
                check(err <= tol, f"sharded {spec} {name} ({eng.shard_kind}) x{n} at bucket "
                      f"{bucket}: off the single-device engine by {err} > {tol}")
                check((got.argmax(1) == want.argmax(1)).all(), f"sharded {spec} {name} argmax")
                key = f"{name}:{eng.shard_kind}"
                worst[key] = max(worst.get(key, 0.0), err)
                served[key] = served.get(key, 0) + 1
                answer_margin = min(answer_margin, margin(want))
        finally:
            pool.stop()
        check(sum(served.values()) == SHARDED_REQUESTS, f"sharded {spec}: served {served}")
        for i, eng in enumerate(pool.engines):
            if eng.shard_kind == "dp":
                continue
            kind, gate = eng.shard_kind, eng.parity_report["f32"]
            check(gate["passed"] and gate["tolerance"] == sharded.SHARDED_PARITY_TOL[kind],
                  f"sharded {spec} r{i} gate {gate}")
            x_slice, _ = eng._parity_slice()
            xt = torch.from_numpy(x_slice).to(eng.device)
            with eng.on_stream():
                ref_slice = refs[kind](eng._host_served, xt).cpu().numpy()
            row = {"spec": spec, "replica": f"r{i}", "devices": len(eng.mesh.devices),
                   "buckets": [eng.buckets[0], eng.buckets[-1]], "warmup_and_gate_s": warm_s,
                   "gate": gate, "parity_slice_min_top1_margin": margin(ref_slice),
                   "requests_min_top1_margin": answer_margin,
                   "max_abs_vs_single_device": worst, "served_by": served}
            if kind == "ep":
                loads = metrics.expert_load_snapshot()
                row["expert_load"] = loads
                row["expert_imbalance"] = sharded.expert_imbalance(list(loads.values()))
                check(sum(loads.values()) > 0, f"sharded {spec}: no expert load recorded")
            if kind == "pp":
                whole = sharded.reference_fn("pp", None)(eng._host_served, xt).cpu().numpy()
                gap = float(np.abs(whole - ref_slice).max())
                row["whole_bucket_anchor_gap"] = gap
                check(gap <= 1e-5 and (whole.argmax(1) == ref_slice.argmax(1)).all(),
                      f"pp: the whole-bucket forward off the microbatch anchor by {gap}")
            row["ms_per_batch_128"] = ms_per_batch(lambda: eng.launch(x128, 128).wait())
            if kind in ("tp", "pp"):
                row["dp_engine_ms_per_batch_128"] = single_ms
            else:
                model = sharded.single_device_model(kind, eng._host_served, eng._vit_cfg).to(eng.device)
                x128t = torch.from_numpy(x128).to(eng.device)

                def forward():
                    with eng.on_stream(), torch.inference_mode():
                        model(x128t)
                    sync()

                row["single_device_forward_ms_per_batch_128"] = ms_per_batch(forward)
            out[spec if spec not in out else f"{spec}/r{i}"] = row
    buf = io.StringIO()
    argv = ["--replicas", "2", "--replica-shapes", "tp2,dp", "--warmup-only"]
    with contextlib.redirect_stdout(buf):
        rc = serve_main(argv + ([] if device == "cuda" else ["--device", "cpu"]))
    cli = buf.getvalue().strip()
    check(rc == 2 and "needs 3 devices but only 1 are visible" in cli,
          f"the CLI did not refuse tp2,dp on one device: rc {rc}, {cli!r}")
    sync()
    check(counts() == before, f"the sharded path launched a kernel: {before} -> {counts()}")
    emit({"phase": "sharded", "nvidia_smi": smi,
          "note": "k shards serialized on one card through an explicit device list: a "
                  "correctness run, not a sharding speed",
          "kinds": out, "cli_refusal": {"argv": argv, "exit": rc, "line": cli},
          "kernel_launches": 0, "seconds": time.perf_counter() - t_phase})
    return out


def stream_overlap(trace: dict) -> dict:
    """Device kernels per stream in a Chrome trace, and how long kernels of
    two different streams ran at the same time."""
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    by_stream: dict = {}
    for e in kernels:
        by_stream.setdefault(e.get("args", {}).get("stream", e.get("tid")), []).append(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
    spans = sorted((lo, hi, s) for s, ivs in by_stream.items() for lo, hi in ivs)
    overlap_us, pairs = 0.0, 0
    for i, (lo, hi, s) in enumerate(spans):
        for lo2, hi2, s2 in spans[i + 1:]:
            if lo2 >= hi:
                break
            if s2 != s:
                overlap_us += min(hi, hi2) - lo2
                pairs += 1
    busy = sum(hi - lo for lo, hi, _ in spans)
    return {"kernels": len(kernels), "streams": {str(s): len(v) for s, v in by_stream.items()},
            "kernel_us": busy, "overlap_us": overlap_us, "overlapping_pairs": pairs}


def two_stream_head_us(torch, q: dict, feats, streams, calls: int = BACK_TO_BACK_CALLS,
                       reps: int = 5) -> dict:
    """Row 1's device time a call at n = 128, as :func:`back_to_back_ms`
    times it (``calls`` launches between one pair of events, behind a sleep
    kernel): on one replica's stream, then alternating between the two
    replicas' streams (the end is the later of the two streams' ends)."""
    from pytorch_mnist_ddp_tpu_torch.ops.int8_head import fused_int8_head

    def run(order) -> float:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(order[0]):
            torch.cuda._sleep(100_000_000)
        start.record(order[0])
        for s in order[1:]:
            s.wait_event(start)
        for i in range(calls):
            with torch.cuda.stream(order[i % len(order)]):
                fused_int8_head(q["fc1"], q["fc2"], feats)
        ends = []
        for s in order:
            e = torch.cuda.Event(enable_timing=True)
            e.record(s)
            ends.append(e)
        torch.cuda.synchronize()
        return 1e3 * max(start.elapsed_time(e) for e in ends) / calls

    for s in streams:  # q and feats were made on the default stream
        s.wait_stream(torch.cuda.current_stream())
    run(streams)  # warm
    return {"calls": calls,
            "one_stream_us_per_call": statistics.median(run(streams[:1]) for _ in range(reps)),
            "two_streams_us_per_call": statistics.median(run(streams) for _ in range(reps))}


def children_of(pid: int) -> dict[int, str]:
    """The live processes whose parent is ``pid``: pid -> command line."""
    import os

    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) == pid and fields[0] != "Z":
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    out[int(entry)] = f.read().replace(b"\0", b" ").decode()
        except (OSError, ValueError, IndexError):
            continue
    return out


def free_ports(k: int) -> int:
    """The first of ``k`` consecutive TCP ports on 127.0.0.1 free now, below
    the ephemeral range: backends bind them seconds later, and meanwhile
    every client connection on the host takes an ephemeral port as its
    source port."""
    import random
    import socket

    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    for base in random.Random().sample(range(10000, low - k), 200):
        ports = set(range(base, base + k))
        if ports & _HANDED_OUT:  # an earlier call's, maybe not bound yet
            continue
        try:
            for p in ports:
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
        except OSError:
            continue
        _HANDED_OUT.update(ports)
        return base
    raise RuntimeError(f"no {k} consecutive free ports under {low}")


_HANDED_OUT: set[int] = set()


# The fleet and loadgen phases' launch counter, written as sitecustomize.py
# into a directory on the PYTHONPATH of the processes they start, which
# those processes' backends inherit.  A process that has imported
# ops/int8_head writes that module's own count, LAUNCHES (one a launch,
# at the launch), to <dir>/int8_head.<pid> every 50 ms and at exit; it
# never imports the module, so a front stays free of torch.  A SIGKILL
# loses what the process launched in its last 50 ms.  A sitecustomize
# further down sys.path still runs.
LAUNCH_COUNTER_SITE = """\
import atexit
import importlib.machinery
import importlib.util
import os
import sys
import threading
import time

_DIR = os.environ.get("CHIP_SMOKE_LAUNCH_DIR")


def _dump():
    # None until the module has run as far as LAUNCHES: it sits in
    # sys.modules from the start of its import, and an AttributeError here
    # would end the loop's thread for good
    count = getattr(sys.modules.get("pytorch_mnist_ddp_tpu_torch.ops.int8_head"), "LAUNCHES",
                    None)
    if count is None:
        return
    path = os.path.join(_DIR, "int8_head.%d" % os.getpid())
    tmp = "%s.tmp%d" % (path, threading.get_ident())
    with open(tmp, "w") as f:
        f.write(str(count))
    os.replace(tmp, path)


def _loop():
    while True:
        time.sleep(0.05)
        _dump()


if _DIR:
    atexit.register(_dump)
    threading.Thread(target=_loop, name="launch-counter", daemon=True).start()

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or os.curdir) != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


def fleet_phase(torch, np, workdir: str, store: str) -> tuple[dict, dict]:
    """The fleet phase (module docstring, 22): the serving CLI's --fleet on
    the card, every backend on the compile phase's store ``store`` and on
    a host without nvcc.  Returns row 1's launches on the path, read from
    each backend process's own counter (LAUNCH_COUNTER_SITE), and apart
    those of the in-process reference engine."""
    import os
    import signal

    from pytorch_mnist_ddp_tpu_torch.obs.events import read_events
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
    from pytorch_mnist_ddp_tpu_torch.serving import wire
    from pytorch_mnist_ddp_tpu_torch.serving.engine import PARITY_SEED, InferenceEngine
    from pytorch_mnist_ddp_tpu_torch.serving.server import decode_instances

    t_phase = time.perf_counter()
    at = functools.partial(os.path.join, workdir)
    here = os.path.dirname(os.path.abspath(__file__))
    counter_dir = at("launch_counter")
    os.makedirs(counter_dir)
    with open(os.path.join(counter_dir, "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_COUNTER_SITE)
    path = [here, counter_dir, *filter(None, [os.environ.get("PYTHONPATH")])]
    env = no_nvcc_env({**os.environ, "CHIP_SMOKE_LAUNCH_DIR": counter_dir,
                       "PYTHONPATH": os.pathsep.join(path)}, at("no_toolkit"))

    def text(path: str) -> str:
        with open(path, errors="replace") as f:
            return f.read()

    def metrics(url: str) -> dict:
        return json.loads(get(url + "/metrics"))

    def ready(port: int) -> bool:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=0.5) as r:
                return r.status == 200
        except OSError:
            return False

    fronts: dict[int, dict] = {}
    seen: dict[int, str] = {}  # every backend process met: pid -> command line

    def start(n: int) -> None:
        port, base = free_port(), free_ports(n)
        tel, log = at(f"fleet{n}_tel"), at(f"fleet{n}.log")
        cmd = [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.serving", "--fleet", str(n),
               "--dtypes", "f32,int8", "--int8-impl", "pallas", "--aot-cache", store,
               "--seed", str(SEED), "--timeout-ms", str(POOL_TIMEOUT_MS),
               "--port", str(port), "--fleet-base-port", str(base),
               "--fleet-heartbeat-timeout-s", str(FLEET_HEARTBEAT_S),
               "--fleet-ready-timeout-s", str(FLEET_READY_S), "--telemetry-dir", tel]
        handle = open(log, "w")
        fronts[n] = {"proc": subprocess.Popen(cmd, cwd=workdir, env=env, stdout=handle,
                                              stderr=subprocess.STDOUT),
                     "handle": handle, "url": f"http://127.0.0.1:{port}", "base": base,
                     "tel": tel, "log": log, "t0": time.perf_counter()}

    def backend_pids(n: int) -> dict[str, int]:
        fr = fronts[n]
        found = {}
        for pid, cmd in children_of(fr["proc"].pid).items():
            for i in range(n):
                if "pytorch_mnist_ddp_tpu_torch.serving" in cmd and f"--port {fr['base'] + i} " \
                        in cmd + " ":
                    found[f"b{i}"] = pid
                    seen[pid] = cmd
        return found

    def stop_front(n: int) -> int | None:
        """SIGTERM the front (it drains and grace-stops its backends); one
        still running after a minute is killed.  Its exit code."""
        fr = fronts[n]
        if "rc" not in fr:
            backend_pids(n)
            fr["rc"] = None
            try:
                fr["proc"].send_signal(signal.SIGTERM)
                fr["rc"] = fr["proc"].wait(timeout=60)
            except subprocess.TimeoutExpired:
                fr["proc"].kill()
                fr["proc"].wait()
            finally:
                fr["handle"].close()
        return fr["rc"]

    def active_since(url: str, name: str, t0: float, what: str) -> float:
        """Seconds from ``t0`` until the front reads backend ``name``
        active again after one replacement."""
        while True:
            snap = metrics(url)
            sup = (snap["fleet"]["supervisor"] or {}).get("backends", {}).get(name, {})
            if snap["backends"][name]["state"] == "active" and sup.get("restarts") == 1:
                return time.perf_counter() - t0
            check(time.perf_counter() - t0 < FLEET_READY_S, f"fleet: {what}: {snap['backends']}")
            time.sleep(0.02)

    ok: dict = {}
    record: dict = {}
    launches, references = {"int8_head": 0}, {"int8_head": 0}
    try:
        # Setup: the two-backend fleet the checks run on, and beside it a
        # fleet of one for (c) (each front a process of its own, started
        # together)
        for n in (1, FLEET_BACKENDS):
            start(n)
        backend_ready_s, front_ready_s = {}, {}
        pending = {(n, i) for n in fronts for i in range(n)}
        while pending or len(front_ready_s) < len(fronts):
            for n, fr in fronts.items():
                rc = fr["proc"].poll()
                check(rc is None, f"fleet {n} exited {rc}: {text(fr['log'])[-3000:]}")
                waited = time.perf_counter() - fr["t0"]
                check(waited < FLEET_READY_S, f"fleet {n} not up after {waited:.0f} s: "
                      f"{text(fr['log'])[-3000:]}")
                for i in range(n):
                    if (n, i) in pending and ready(fr["base"] + i):
                        backend_ready_s[f"fleet{n}_b{i}"] = time.perf_counter() - fr["t0"]
                        pending.discard((n, i))
                if n not in front_ready_s and "fleet front on" in text(fr["log"]):
                    front_ready_s[f"fleet{n}"] = time.perf_counter() - fr["t0"]
            time.sleep(0.05)
        record["seconds_to_ready"] = {"backends": backend_ready_s, "fronts": front_ready_s}
        for n in fronts:
            check(len(backend_pids(n)) == n, f"fleet {n}: backends {backend_pids(n)}")

        # The reference: a single engine in this process on the same seed,
        # cuDNN as the serving CLI leaves it; its launches counted apart
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = False
        before = ih.LAUNCHES
        try:
            single = InferenceEngine.from_seed(SEED, dtypes=("int8",))
            single.warmup()
            check(single.verify_parity()["int8"]["passed"], "fleet: the reference engine's gate")
            raw = np.random.RandomState(PARITY_SEED + 20).randint(
                0, 256, (320, 28, 28)).astype(np.uint8)
            x = decode_instances({"instances": raw.tolist()})
            ref = {"raw": raw, **{dt: single.predict_logits(x, dtype=dt)
                                  for dt in ("f32", "int8")}}
            # Every row staged at every bucket, in batches of exactly the
            # bucket (the last one filled up with the first rows): a row's
            # answer depends on its bucket, not on its batch-mates
            ref["by_bucket"] = {dt: {} for dt in ("f32", "int8")}
            for b in single.buckets:
                idx = np.arange(-(-len(x) // b) * b) % len(x)
                for dt in ("f32", "int8"):
                    ref["by_bucket"][dt][b] = np.concatenate([
                        single.predict_logits(x[idx[i:i + b]], dtype=dt)
                        for i in range(0, len(idx), b)])[:len(x)]
            rs = np.random.RandomState(PARITY_SEED + 21)
            seeded = []
            for i in range(FLEET_REQUESTS):
                size = int(rs.randint(1, 13))
                off = int(rs.randint(0, len(raw) - size))
                dtype = ("f32", "int8")[i % 2]
                seeded.append((off, size, dtype, (i // 2) % 2 == 1,
                               single.predict_logits(x[off:off + size], dtype=dtype)))
            rungs = len(single.buckets)  # the CLI's default ladder, as the backends'
            del single
        finally:
            torch.backends.cudnn.deterministic = deterministic
            references["int8_head"] = ih.LAUNCHES - before

        url = fronts[FLEET_BACKENDS]["url"]
        tel = fronts[FLEET_BACKENDS]["tel"]
        names = [f"b{i}" for i in range(FLEET_BACKENDS)]
        backend_log = lambda name: text(os.path.join(tel, f"backend-{name}.log"))  # noqa: E731

        # (a) every backend active off the store, its gate passed, and each
        # front's answers the single engine's at the same bucket
        snap = metrics(url)
        equal = {}
        for n, fr in fronts.items():
            for i, (off, size, dtype, binary, want) in enumerate(seeded):
                rows = raw[off:off + size]
                if binary:
                    status, body, _ = http_post(fr["url"] + "/predict", wire.encode_request(
                        rows.astype(np.float32), dtype=dtype), wire.WIRE_REQUEST_TYPE)
                    got = wire.decode_response(body) if status == 200 else None
                else:
                    status, body, _ = http_post(fr["url"] + "/predict", predict_body(rows, dtype))
                    got = log_probs(body) if status == 200 else None
                equal[f"fleet{n}:{i}:{dtype}:{'binary' if binary else 'json'}:{size}"] = (
                    got is not None and bool(np.array_equal(got, want)))
        ok["a_serving"] = {
            "active": sorted(snap["backends"]) == names
            and all(b["state"] == "active" for b in snap["backends"].values()),
            "compiles_0": all(b["compiles"] == 0 for b in snap["backends"].values()),
            "gates_pass": all("parity gate [int8]: PASS" in backend_log(n) for n in names),
            "no_nvcc_store_hit": all(", 0 nvcc builds" in backend_log(n)
                                     and "(int8_head: hit)" in backend_log(n) for n in names),
            "answers_equal_single_engine": all(equal.values())}
        if not all(equal.values()):
            record["a_unequal"] = [k for k, v in equal.items() if not v]

        # (b) and (c) together, their replacements starting side by side:
        # (b) the two-backend fleet's b1 SIGKILLed under 8 closed-loop
        # clients, every request one 200, b1 replaced off the store; (c)
        # the fleet of one's b0 SIGSTOPped when the clients start: its
        # heartbeat goes stale, the supervisor records that and replaces it
        pids = backend_pids(FLEET_BACKENDS)
        stopped = backend_pids(1)["b0"]
        stop = threading.Event()
        answered = [0]
        kill = {}

        def progress(k: int) -> None:
            answered[0] = k
            if k >= FLEET_KILL_AFTER and not kill:
                kill["t"] = time.perf_counter()
                kill["at"] = k
                os.kill(pids["b1"], signal.SIGKILL)

        with ThreadPoolExecutor(1) as runner:
            t_stop = time.perf_counter()
            os.kill(stopped, signal.SIGSTOP)
            drive = runner.submit(pool_clients, url, ref, POOL_CLIENTS, 1 << 20, seed=8,
                                  progress=progress, stop=stop)
            try:
                poll(lambda: bool(kill) or drive.done(), "(b) the kill", FLEET_READY_S)
                check(bool(kill), "(b) the clients ended before the kill")
                kill_to_active = active_since(url, "b1", kill["t"], "(b) b1 not replaced")
                after = answered[0]
                poll(lambda: answered[0] >= after + FLEET_KILL_AFTER or drive.done(),
                     "(b) answers after the replacement", FLEET_READY_S)
            finally:
                stop.set()
            run = drive.result()
        stop_to_active = active_since(fronts[1]["url"], "b0", t_stop, "(c) b0 not replaced")
        prom = get(url + "/metrics?format=prom").decode()
        snap = metrics(url)
        b1_log = backend_log("b1")
        ok["b_kill"] = {
            "every_request_one_200": not run["bad"] and not run["rejected"]
            and len(run["answered"]) >= kill["at"] + FLEET_KILL_AFTER,
            "restarts_1": 'fleet_backend_restarts_total{backend="b1"} 1' in prom,
            "replacement_compiles_0": snap["backends"]["b1"]["compiles"] == 0,
            "replacement_no_nvcc": b1_log.count("warmup verified: ") == 2
            and b1_log.count(", 0 nvcc builds") == 2,
            "a_new_process": backend_pids(FLEET_BACKENDS).get("b1") not in (None, pids["b1"])}
        lat = run["latencies_ms"]
        record["b_kill"] = {"requests": len(lat), "killed_after": kill["at"],
                            "kill_to_active_s": kill_to_active,
                            "max_abs_err": run["max_abs_err"],
                            "requests_by_bucket": run["requests_by_bucket"],
                            "client_p50_ms": float(np.percentile(lat, 50)),
                            "client_p99_ms": float(np.percentile(lat, 99)),
                            "client_max_ms": float(max(lat))}
        incidents = {n: [(e["event"], e["backend"], e.get("reason"))
                         for e in read_events(os.path.join(fronts[n]["tel"],
                                                           "events-fleet.jsonl"))
                         if e["event"] in ("backend_death", "backend_replace", "backend_eject")]
                     for n in fronts}
        record["incidents"] = incidents
        ok["c_hang"] = {
            "stop_is_a_heartbeat_incident": incidents[1] == [
                ("backend_death", "b0", "heartbeat"), ("backend_replace", "b0", None)],
            "kill_is_a_dead_incident": incidents[FLEET_BACKENDS] == [
                ("backend_death", "b1", "dead"), ("backend_replace", "b1", None)],
            "stopped_process_gone": stopped not in children_of(fronts[1]["proc"].pid),
            "replacement_compiles_0": metrics(fronts[1]["url"])["backends"]["b0"]["compiles"]
            == 0}
        record["c_hang"] = {"stop_to_active_s": stop_to_active}
        for n in fronts:
            record[f"fleet{n}_exit"] = stop_front(n)
        ok["exit"] = {"fronts_exit_0": record["fleet1_exit"] == record["fleet2_exit"] == 0}

        # Row 1 on the path: each backend process's own counter, and beside
        # it what the process's telemetry (one run_id a process) implies,
        # its int8 rungs and gate and the int8 batches it served
        counts = {}
        for entry in os.listdir(counter_dir):
            kind, _, pid = entry.partition(".")
            if kind == "int8_head" and pid.isdigit():
                with open(os.path.join(counter_dir, entry)) as f:
                    counts[int(pid)] = int(f.read())
        killed = {stopped, pids["b1"]}  # (c)'s stopped b0 and (b)'s b1
        processes, unpaired = {}, {}
        for n, names_n in ((1, ["b0"]), (FLEET_BACKENDS, names)):
            for i, name in enumerate(names_n):
                told = {}  # run_id -> counts, in the order the processes ran
                for e in read_events(os.path.join(fronts[n]["tel"], name, "events-rank0.jsonl")):
                    c = told.setdefault(e["run_id"], {"rungs": 0, "gates": 0, "batches": 0})
                    c["rungs"] += (e["event"] == "span_end" and e["span"] == "compile"
                                   and e.get("fn", "").startswith("predict_step[int8]"))
                    c["gates"] += e["event"] == "parity_gate" and e["dtype"] == "int8"
                    c["batches"] += (e["event"] == "serving_batch"
                                     and e["dtype"].split("@")[0] == "int8")
                # the backend's processes in the order they ran: a killed one first
                procs = sorted((pid for pid, cmd in seen.items()
                                if f"--port {fronts[n]['base'] + i} " in cmd + " "),
                               key=lambda pid: pid not in killed)
                key = f"fleet{n}_{name}"
                if len(procs) != len(told):
                    unpaired[key] = {"processes": procs, "telemetry_runs": list(told.values())}
                processes[key] = [{"pid": pid, "ended": "killed" if pid in killed else "SIGTERM",
                                   "launches": counts.get(pid), **c}
                                  for pid, c in zip(procs, told.values())]
        record["int8_head_by_process"] = processes
        if unpaired:
            record["int8_head_unpaired"] = unpaired
        every = [p for runs in processes.values() for p in runs]
        ok["launches"] = {
            "every_process_counted": set(counts) == set(seen),
            # the fleet of one's b0 and the fleet of two's b1 were replaced
            "processes_by_backend": not unpaired
            and [len(runs) for runs in processes.values()] == [2, 1, 2],
            "one_gate_a_process": all(p["gates"] == 1 for p in every),
            "rungs_a_process": all(p["rungs"] == rungs for p in every),
            "int8_batches": all(sum(p["batches"] for p in runs) > 0
                                for runs in processes.values()),
            "counted_its_warmup_and_gate": all((p["launches"] or 0) >= rungs + 1 for p in every),
            # one launch a rung, one for the gate, one an int8 batch
            "counter_is_its_telemetry_on_sigterm": all(
                p["launches"] == p["rungs"] + p["gates"] + p["batches"]
                for p in every if p["ended"] == "SIGTERM")}
        launches["int8_head"] = sum(counts.values())
    finally:
        for n in fronts:
            stop_front(n)
        # A backend a front left behind (the front was killed, or a
        # stopped backend outlived it): still the same command line, so
        # not a reused pid
        for pid, cmd in seen.items():
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    if f.read().replace(b"\0", b" ").decode() != cmd:
                        continue
                os.kill(pid, signal.SIGCONT)
                os.kill(pid, signal.SIGKILL)
            except OSError:
                continue
    emit({"phase": "fleet", "backends": FLEET_BACKENDS, "checks": ok, "record": record,
          "launches": launches, "reference_launches": references,
          "seconds": time.perf_counter() - t_phase})
    for name, checks in ok.items():
        check(all(checks.values()), f"fleet {name}: {checks}")
    return launches, references


def loadgen_phase(torch, np, workdir: str, store: str, smi: str, device: str = "cuda") -> dict:
    """The loadgen phase (module docstring, 23): the SLO gate (a) and the
    fleet sweep (c) in processes of their own, started together, and
    meanwhile (b) in this process.  Returns row 1's launches on the path:
    (b)'s from ops/int8_head.LAUNCHES, (a)'s and (c)'s from each process's
    own counter (LAUNCH_COUNTER_SITE)."""
    import contextlib
    import io
    import os

    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
    from pytorch_mnist_ddp_tpu_torch.tools import serve_loadgen as lg

    t_phase = time.perf_counter()
    at = functools.partial(os.path.join, workdir)
    here = os.path.dirname(os.path.abspath(__file__))
    reports = os.path.join(here, "build", "loadgen")
    counter_dir = at("launch_counter")
    os.makedirs(counter_dir)
    with open(os.path.join(counter_dir, "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_COUNTER_SITE)
    path = [here, counter_dir, *filter(None, [os.environ.get("PYTHONPATH")])]
    env = no_nvcc_env({**os.environ, "CHIP_SMOKE_LAUNCH_DIR": counter_dir,
                       "PYTHONPATH": os.pathsep.join(path)}, at("no_toolkit"))
    int8 = ["--device", device, "--dtype", "int8", "--int8-impl", "pallas", "--aot-cache", store]

    def text(path: str) -> str:
        with open(path, errors="replace") as f:
            return f.read()

    def report(name: str) -> dict:
        with open(os.path.join(reports, name)) as f:
            return json.load(f)

    procs: dict[str, dict] = {}

    def start(name: str, argv: list[str]) -> None:
        handle = open(at(f"{name}.log"), "w")
        procs[name] = {"proc": subprocess.Popen([sys.executable, "-m", *argv], cwd=here, env=env,
                                                stdout=handle, stderr=subprocess.STDOUT),
                       "handle": handle, "log": at(f"{name}.log"), "t0": time.perf_counter()}

    def finish(name: str) -> int | None:
        p = procs[name]
        if "rc" not in p:
            try:
                p["rc"] = p["proc"].wait(timeout=max(1.0, LOADGEN_PROC_TIMEOUT_S
                                                     - (time.perf_counter() - p["t0"])))
            except subprocess.TimeoutExpired:
                p["proc"].kill()
                p["rc"] = p["proc"].wait()
            p["seconds"] = time.perf_counter() - p["t0"]
            p["handle"].close()
        return p["rc"]

    ok: dict = {}
    record: dict = {"nvidia_smi": smi}
    launches = {"int8_head": 0}
    try:
        start("gate", ["pytorch_mnist_ddp_tpu_torch.tools.slo_gate", "--device", device,
                       "--workdir", at("gate"), "--keep"])
        start("fleet", ["pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen", *int8,
                        "--fleet-sweep", "1,2", "--open-loop",
                        "--rate", str(LOADGEN_FLEET_RATE),
                        "--requests", str(LOADGEN_FLEET_REQUESTS),
                        "--fleet-base-port", str(free_ports(2)),
                        "--telemetry-dir", at("fleet_tel")])

        # (b) in this process: the pool's closed-loop rate, then the tail
        # A/B at 1.2 times it, so the queue stays deep
        before = ih.LAUNCHES
        out = io.StringIO()
        args = lg.build_parser().parse_args(
            [*int8, "--replicas", "2", "--requests", str(LOADGEN_CLOSED_PLAN)])
        with contextlib.redirect_stdout(out):
            server, sink, url = lg._spin_self_serve(args, replicas=2)
        try:
            plan = lg.build_plan(args)
            lock = threading.Lock()
            closed = {"latencies_ms": [], "statuses": {}}
            stop_at = time.perf_counter() + LOADGEN_CLOSED_S

            def client(c: int) -> None:
                i = c
                while time.perf_counter() < stop_at:
                    k = i % len(plan["bodies"])
                    i += LOADGEN_CLIENTS
                    t0 = time.perf_counter()
                    status, data = lg.fetch_raw(url + "/predict", plan["bodies"][k],
                                                plan["headers"][k], timeout=30.0)
                    lg._decode_reply(plan["wire"], status, data)
                    ms = 1e3 * (time.perf_counter() - t0)
                    with lock:
                        closed["latencies_ms"].append(ms)
                        closed["statuses"][status] = closed["statuses"].get(status, 0) + 1

            t0 = time.perf_counter()
            with ThreadPoolExecutor(LOADGEN_CLIENTS) as pool:
                list(pool.map(client, range(LOADGEN_CLIENTS)))
            closed_s = time.perf_counter() - t0
        finally:
            lg._teardown_self_serve(server, sink)
        lat = closed["latencies_ms"]
        rate = closed["statuses"].get(200, 0) / closed_s
        record["b_closed_loop"] = {
            "clients": LOADGEN_CLIENTS, "seconds": closed_s, "requests": len(lat),
            "statuses": {str(k): v for k, v in closed["statuses"].items()}, "rps": rate,
            "client_p50_ms": float(np.percentile(lat, 50)),
            "client_p99_ms": float(np.percentile(lat, 99))}
        offered = LOADGEN_OVERLOAD * rate
        tail_path = os.path.join(reports, "BENCH_tail.json")
        with contextlib.redirect_stdout(out):
            tail_rc = lg.main([*int8, "--ab-tail", "--open-loop", "--rate", f"{offered:.1f}",
                               "--requests", str(int(offered * LOADGEN_TAIL_S)),
                               "--replicas", "2", "--qos-mix", LOADGEN_MIX,
                               "--tail-report", tail_path])
        launches_b = ih.LAUNCHES - before
        tail = report("BENCH_tail.json")
        ok["b_pool"] = {
            "closed_loop_all_200": set(closed["statuses"]) == {200},
            "ab_tail_exit_0": tail_rc == 0,
            "nothing_lost_or_duplicated": all(
                r["lost"] == r["transport_errors"] == r["duplicates"] == 0
                for r in tail["rungs"]),
            "firewall_held": all(r["additional_compiles"] == 0 for r in tail["rungs"]),
            "row1_launched": launches_b > 0}
        record["b_ab_tail"] = {
            "offered_rps": tail["offered_rate_rps"], "requests": tail["requests"],
            "rungs": {r["label"]: {
                "goodput_rps": r["goodput_rps"], "rejected": r["rejected"],
                "timed_out": r["timed_out"], "hedges": r["server_hedges"],
                "p50_ms": r["latency_ms"]["p50"], "p99_ms": r["latency_ms"]["p99"],
                "by_class": {q: {k: v[k] for k in ("requests", "ok", "rejected", "timed_out",
                                                   "p50", "p95", "p99")}
                             for q, v in (r["qos_latency_ms"] or {}).items()}}
                for r in tail["rungs"]},
            "goodput_ratio_tail_vs_baseline": tail["goodput_ratio_tail_vs_baseline"]}
        if not all(ok["b_pool"].values()):
            record["b_stdout_tail"] = out.getvalue()[-3000:]

        # (a) the gate and (c) the fleet sweep, waited on
        gate_rc, fleet_rc = finish("gate"), finish("fleet")
        gate_log, fleet_log = text(procs["gate"]["log"]), text(procs["fleet"]["log"])
        with open(os.path.join(reports, "BENCH_slo.json")) as f:
            row = json.load(f)[-1]
        ok["a_gate"] = {
            "exit_0": gate_rc == 0, "pass_line": "SLO GATE: PASS" in gate_log,
            "row_passed": row["pass"] and not row["failures"] and row["device"] == device,
            "no_library_built": row["measured"]["library_builds"] == 0}
        record["a_gate"] = {"seconds": procs["gate"]["seconds"], "measured": row["measured"],
                            "budgets": row["budgets"]}
        fleet = report("BENCH_fleet.json")
        kill = fleet["recovery_under_kill"] or {}
        tel = at("fleet_tel")
        backend_logs = sorted(name for name in os.listdir(tel) if name.startswith("backend-"))
        warm = [ln for name in backend_logs for ln in text(os.path.join(tel, name)).splitlines()
                if "warmup verified: " in ln]
        ok["c_fleet"] = {
            "exit_0": fleet_rc == 0, "real_backends": fleet["backend_kind"] == "process",
            "compiles_0_every_rung": all(r["additional_compiles"] == 0 for r in fleet["sweep"]),
            "kill_lost_0": kill.get("lost") == 0 and kill.get("transport_errors") == 0,
            "killed_backend_replaced": bool(kill.get("replaced")),
            "replacement_compiles_0": kill.get("replacement_compiles") == 0,
            # 1 + 2 backends in the sweep, 2 in the kill round and the replacement
            "every_backend_a_store_hit": len(warm) == 6 and all(
                "(int8_head: hit)" in ln and ", 0 nvcc builds" in ln for ln in warm)}
        record["c_fleet"] = {
            "seconds": procs["fleet"]["seconds"], "offered_rps": fleet["offered_rate_rps"],
            "sweep": [{k: r[k] for k in ("backends", "goodput_rps", "answered_rps", "wall_s",
                                         "p50_ms", "p99_ms", "rejected", "timed_out")}
                      for r in fleet["sweep"]],
            "kill": {k: kill.get(k) for k in ("killed", "kill_at_s", "rejected",
                                              "rejected_rate", "mean_replacement_s",
                                              "goodput_rps")}}
        if not all(ok["c_fleet"].values()):
            record["c_log_tail"] = fleet_log[-3000:]
        if not all(ok["a_gate"].values()):
            record["a_log_tail"] = gate_log[-3000:]

        # Row 1 on the path: (b) in this process, and each other process's
        # own counter (the gate's loadgens serve f32 and launch none)
        counts = {}
        for entry in os.listdir(counter_dir):
            kind, _, pid = entry.partition(".")
            if kind == "int8_head" and pid.isdigit():
                with open(os.path.join(counter_dir, entry)) as f:
                    counts[int(pid)] = int(f.read())
        launches["int8_head"] = launches_b + sum(counts.values())
        record["int8_head"] = {"b_in_process": launches_b, "by_process": counts}
        ok["launches"] = {"fleet_backends_counted": sum(counts.values()) > 0}
    finally:
        for name in procs:
            finish(name)
    emit({"phase": "loadgen", "checks": ok, "record": record, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    for name, checks in ok.items():
        check(all(checks.values()), f"loadgen {name}: {checks}")
    return launches


def main() -> int:
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    import numpy as np

    from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.models.quant import (
        conv_stack,
        qparams_to,
        quantize_params,
    )
    from pytorch_mnist_ddp_tpu_torch.ops import _build
    from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
    from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa
    from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
    from pytorch_mnist_ddp_tpu_torch.serving.engine import PARITY_SEED, InferenceEngine
    from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
    from pytorch_mnist_ddp_tpu_torch.serving.server import make_server

    # 1. env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                   "matmul": torch.backends.cuda.matmul.allow_tf32}})

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.sources())) as pool:
        list(pool.map(_build.library, _build.sources()))
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_entries(_build.ptxas_report(name)) for name in _build.sources()}
    check(all(found and all(e["arch"] == "sm_90a" for e in found.values())
              for found in ptxas.values()), f"a kernel was not built for sm_90a: {ptxas}")
    k, h, o = 9216, 128, 10  # the CNN's fc1 -> fc2 head
    head_plans = {str(n): ih.launch_plan(n, k, h, o, dev.index) for n in TIMED_ROWS}
    emit({"phase": "build", "sources": _build.sources(), "seconds": build_s, "ptxas": ptxas,
          "int8_head_active_clusters": ih.active_clusters(dev.index, k, h, o),
          "int8_head_plan_by_n": {n: {key: p[key] for key in ("cluster", "grid", "smem",
                                                             "max_clusters", "waves")}
                                  for n, p in head_plans.items()}})

    # 3. kernel against its plain version, at the ladder's row counts
    state = Net(torch.Generator().manual_seed(SEED)).state_dict()
    q = qparams_to(quantize_params(state), dev)
    fc1, fc2 = q["fc1"], q["fc2"]
    raw = np.random.RandomState(PARITY_SEED).randint(
        0, 256, (max(KERNEL_ROWS), 28, 28)).astype(np.uint8)
    x_all = normalize(raw)
    with torch.inference_mode():
        feats = conv_stack(q, torch.from_numpy(x_all).to(dev))
    kernel_err = head_kernel_phase(torch, np, fc1, fc2, feats)
    adadelta_err = adadelta_kernel_phase(torch, np)
    flash_err = flash_kernel_phase(torch, np)

    # 4 + 5. the main path; launch counts cover exactly these two phases
    ih.LAUNCHES = 0
    cpu_net = Net()
    cpu_net.load_state_dict(state)
    cpu_net.eval()
    engines = {}
    for packed in (False, True):
        metrics = ServingMetrics()
        engine = InferenceEngine.from_seed(SEED, dtypes=("int8",), packed=packed,
                                           metrics=metrics)
        check(engine.device.type == "cuda", f"engine on {engine.device}")
        t0 = time.perf_counter()
        rungs = engine.warmup()
        warm_s = time.perf_counter() - t0
        gate = engine.verify_parity()["int8"]
        check(gate["passed"], f"int8 parity gate failed: {gate}")
        before = ih.LAUNCHES
        x = x_all[:100]  # past no bucket on the default ladder: one chunk
        out8 = engine.predict_logits(x, dtype="int8")
        check(ih.LAUNCHES > before, "int8 predictions did not launch int8_head")
        out32 = engine.predict_logits(x)
        with torch.inference_mode():
            ref32 = cpu_net(torch.from_numpy(x)).numpy()
        f32_err = float(np.abs(out32 - ref32).max())
        check(np.isfinite(out8).all() and out8.shape == (100, 10), "int8 output")
        check(f32_err <= F32_TOL, f"f32 engine off the CPU model by {f32_err}")
        check((out32.argmax(1) == ref32.argmax(1)).all(), "f32 argmax vs CPU model")
        engines[packed] = (engine, metrics)
        emit({"phase": "engine", "packed": packed, "buckets": list(engine.buckets),
              "rungs": len(rungs), "warmup_s": warm_s, "parity": gate,
              "f32_vs_cpu_max_abs": f32_err,
              "int8_vs_f32_max_abs": float(np.abs(out8 - out32).max())})

    engine, metrics = engines[False]
    server = make_server(engine, metrics, linger_ms=1.0)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    http_err = 0.0
    bodies = [
        json.dumps({"instances": raw[:i].reshape(i, -1).tolist(),
                    "dtype": "int8" if i % 2 else "f32",
                    "return_log_probs": True}).encode()
        for i in range(1, 13)
    ]
    try:
        for i in range(1, 13):
            dtype = "int8" if i % 2 else "f32"
            rows = raw[:i]
            resp = post_json(base + "/predict", bodies[i - 1])
            got = np.asarray(resp["log_probs"], np.float32)
            want = engine.predict_logits(normalize(rows), dtype=dtype)
            err = float(np.abs(got - want).max())
            check(err <= HTTP_TOL, f"/predict {dtype} x{i} off predict_logits by {err}")
            check(resp["predictions"] == want.argmax(1).tolist(), "/predict argmax")
            http_err = max(http_err, err)
        latencies = []
        t_loop = time.perf_counter()
        for j in range(LATENCY_REQUESTS):
            t0 = time.perf_counter()
            post_json(base + "/predict", bodies[j % len(bodies)])
            latencies.append(1e3 * (time.perf_counter() - t0))
        loop_s = time.perf_counter() - t_loop
        snap = json.loads(get(base + "/metrics"))
        prom = get(base + "/metrics?format=prom").decode()
        check("serving_requests_total" in prom, "prometheus exposition")
        check(json.loads(get(base + "/healthz"))["status"] == "ok", "/healthz")
        get(base + "/readyz")
    finally:
        server.shutdown()
        server.batcher.stop(drain=True)
        server.server_close()
        serve.join(timeout=30)
    check(not serve.is_alive(), "server thread did not stop")
    done = metrics.completed
    sent = 12 + LATENCY_REQUESTS
    check(snap["requests"]["completed"] == sent and metrics.failed == 0,
          f"server completed {done} of {sent}, failed {metrics.failed}")
    emit({"phase": "server", "requests": sent, "completed": done,
          "max_abs_vs_predict_logits": http_err,
          "client_closed_loop": {"requests": LATENCY_REQUESTS, "seconds": loop_s,
                                 "p50_ms": float(np.percentile(latencies, 50)),
                                 "p99_ms": float(np.percentile(latencies, 99))},
          "server_submit_to_result_ms": {k: snap["latency_ms"][k]
                                         for k in ("count", "p50", "p99")}})

    # The packed engine behind the server with concurrent clients: the
    # batcher coalesces the requests into one capacity buffer with several
    # segments.  Expected answers are computed before the server
    # starts, since only the dispatch thread may launch while it runs.
    engine, metrics = engines[True]
    want_all = {dt: engine.predict_logits(normalize(raw), dtype=dt)
                for dt in ("f32", "int8")}
    server = make_server(engine, metrics, fill_wait_ms=2.0)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def client(c: int, dtype: str) -> tuple[list[float], float]:
        lat, worst = [], 0.0
        for j in range(PER_CLIENT):
            size = 1 + (c + j) % 12
            off = (7 * c + 13 * j) % (len(raw) - size)
            body = {"instances": raw[off:off + size].reshape(size, -1).tolist(),
                    "dtype": dtype, "return_log_probs": True}
            t0 = time.perf_counter()
            resp = post_json(base + "/predict", body)
            lat.append(1e3 * (time.perf_counter() - t0))
            got = np.asarray(resp["log_probs"], np.float32)
            want = want_all[dtype][off:off + size]
            err = float(np.abs(got - want).max())
            check(err <= HTTP_TOL, f"packed /predict {dtype} x{size} off by {err}")
            check(resp["predictions"] == want.argmax(1).tolist(), "packed /predict argmax")
            worst = max(worst, err)
        return lat, worst

    rounds = {}
    try:
        for dtype in ("f32", "int8"):
            batches, samples = metrics.batches, metrics.snapshot()["samples"]
            t_loop = time.perf_counter()
            with ThreadPoolExecutor(CLIENTS) as pool:
                results = list(pool.map(client, range(CLIENTS), [dtype] * CLIENTS))
            loop_s = time.perf_counter() - t_loop
            after = metrics.snapshot()["samples"]
            batches = metrics.batches - batches
            latencies = [t for lat, _ in results for t in lat]
            rounds[dtype] = {
                "batches": batches, "requests_per_batch": CLIENTS * PER_CLIENT / batches,
                "fill": (after["real"] - samples["real"])
                / (after["dispatched"] - samples["dispatched"]),
                "max_abs_vs_predict_logits": max(w for _, w in results),
                "seconds": loop_s,
                "client_p50_ms": float(np.percentile(latencies, 50)),
                "client_p99_ms": float(np.percentile(latencies, 99)),
            }
    finally:
        server.shutdown()
        server.batcher.stop(drain=True)
        server.server_close()
        serve.join(timeout=30)
    check(not serve.is_alive(), "packed server thread did not stop")
    sent = 2 * CLIENTS * PER_CLIENT
    check(metrics.completed == sent and metrics.failed == 0,
          f"packed server completed {metrics.completed} of {sent}, "
          f"failed {metrics.failed}")
    for dtype, r in rounds.items():
        check(r["requests_per_batch"] > 1.0,
              f"no {dtype} request coalesced: {r['batches']} batches")
    launches = ih.LAUNCHES
    check(launches > 0, "the main path never launched int8_head")
    emit({"phase": "server_packed", "clients": CLIENTS, "requests": sent,
          "completed": metrics.completed, "rounds": rounds,
          "launches_main_path": {"int8_head": launches}})

    # 5b. serving_stack: the single-engine stack; row 1 counted on its
    # path, the references it is held to apart
    ih.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as workdir:
        stack_launches, stack_references = serving_stack_phase(torch, np, workdir)
    check(stack_launches["int8_head"] > 0, "the serving stack never launched int8_head")

    # 5c. pool: the replica pool; row 1 counted on its path (== the int8
    # batches its replicas served), the warmups, gates and references apart
    ih.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as workdir:
        pool_launches, pool_references = pool_phase(torch, np, workdir)

    # 5d. sharded: the sharded replicas on the card through an explicit
    # device list; f32 only, so no kernel of the table runs on this path
    sharded_phase(torch, np, smi)

    # 6-9. the training path; adadelta launch counts cover these four
    for k in af.LAUNCHES:
        af.LAUNCHES[k] = 0
    by_phase = {"train_step": train_step_phase(torch, np)}
    by_phase["train"], per_batch_run = train_phase(torch)
    with tempfile.TemporaryDirectory() as workdir:
        by_phase["resume"], f32_epoch_s = resume_phase(torch, workdir, per_batch_run)
    by_phase["cnn_variants"] = cnn_variants_phase(torch, np, f32_epoch_s)
    train_launches = dict(af.LAUNCHES)
    check(train_launches == {k: sum(p[k] for p in by_phase.values()) for k in train_launches},
          f"adadelta launches {train_launches} outside the four training phases")
    for k, v in train_launches.items():
        check(v > 0, f"the training path never launched {k}")
    check(by_phase["resume"]["adadelta_delta"] > 0, "no delta kernel launch on restored state")

    # 9b. fused: the fused path and the prefetch; their adadelta launches
    # (the launcher rank's included) counted on their own, the per-batch
    # references apart
    for k in af.LAUNCHES:
        af.LAUNCHES[k] = 0
    with tempfile.TemporaryDirectory() as workdir:
        fused_launches, fused_references = fused_phase(torch, np, workdir, per_batch_run)
    del per_batch_run
    check(fused_launches["adadelta_delta"] > 0, "the fused path never launched adadelta_delta")

    # 10. the data-parallel path; the data-parallel step's adadelta
    # counts, the ranks' processes' included, and apart those of the
    # references it is held to
    for k in af.LAUNCHES:
        af.LAUNCHES[k] = 0
    with tempfile.TemporaryDirectory() as workdir:
        ddp_launches, ddp_references = ddp_phase(torch, np, workdir)
    check(ddp_launches["adadelta_delta"] > 0, "the data-parallel path never launched "
          "adadelta_delta")

    # 11. times: int8_head at one row and the ladder's small and top
    # buckets, adadelta at the model's parameter count; 12. train_profile
    by_n, _ = head_times(torch, fc1, fc2, feats)
    head_shapes = head_shape_times(torch, np)
    ada_times = adadelta_times(torch, np)
    train_profile_phase(torch, np)

    # 13 + 14. the ViT training path; flash launch counts cover these two
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    vit_step_launches, vit_step_bf16 = vit_step_phase(torch, np)
    with tempfile.TemporaryDirectory() as workdir:
        vit_fit_launches, vit_fit_bf16, sp1_cut = vit_train_phase(torch, np, workdir)
    vit_bf16_launches = {k: vit_step_bf16[k] + vit_fit_bf16[k] for k in vit_step_bf16}
    vit_launches = dict(fa.LAUNCHES)
    check(vit_launches == {k: vit_step_launches[k] + vit_fit_launches[k] for k in vit_launches},
          f"flash launches {vit_launches} outside the two ViT training phases")
    for k, v in vit_launches.items():
        check(v > 0, f"the ViT training path never launched {k}")
        check(vit_bf16_launches[k] > 0, f"the --bf16 ViT path never launched {k}")

    # 14b. vit_fused: the ViT's --fused; no kernel of the table on its path
    with tempfile.TemporaryDirectory() as workdir:
        vit_fused_phase(torch, np, workdir)

    # 15. where a ViT step's time goes; 16. flash attention times
    vit_profile_phase(torch)
    flash_t = flash_times(torch, np)

    # 17. vit_parallel: (a) the ring's hops in one process (comparison
    # launches, not counted), then the parallel modes' path (b)-(e), whose
    # flash launches the ranks count; the references apart
    ring = ring_hops_phase(torch, np)
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    with tempfile.TemporaryDirectory() as workdir:
        par_launches, par_references = vit_parallel_phase(torch, np, workdir, sp1_cut)
    for k, v in par_launches.items():
        check(v > 0, f"the ViT's parallel path never launched {k}")

    # 18. vit_family: --experts, --zero and --pp; row 4's launches on their
    # path counted by the ranks' processes and the epoch, the references apart
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    with tempfile.TemporaryDirectory() as workdir:
        fam_launches, fam_references = vit_family_phase(torch, np, workdir)
    check(fam_launches["flash_fwd"] > 0, "the vit_family path never launched flash_fwd")

    # 19. train_state: the ViT's archives, --elastic, --resume-reshard,
    # mnist_ddp --tp/--pp, --profile; rows 3-5 counted on its path (the
    # ranks' processes included), the references apart
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    for k in af.LAUNCHES:
        af.LAUNCHES[k] = 0
    with tempfile.TemporaryDirectory() as workdir:
        state_launches, state_references = train_state_phase(torch, np, workdir)
    for k in ("flash_fwd", "flash_partial", "adadelta_delta"):
        check(state_launches[k] > 0, f"the train_state path never launched {k}")

    # 20. resilience: the runtime, telemetry and the gang restart; row 3
    # counted over this process's runs, the references apart
    for k in af.LAUNCHES:
        af.LAUNCHES[k] = 0
    with tempfile.TemporaryDirectory() as workdir:
        res_launches, res_references = resilience_phase(torch, np, workdir)
    check(res_launches["adadelta_delta"] > 0, "the resilience path never launched "
          "adadelta_delta")

    # 21. compile: the startup path, a fresh kernel-library store; rows 1
    # and 3 counted by its processes, the flagless references apart.
    # 22. fleet: the serving fleet's backends on that store; row 1 counted
    # from their telemetry, the reference engine apart.  23. loadgen: the
    # load generator and the SLO gate on that store; row 1 counted in this
    # process and by the other processes
    with tempfile.TemporaryDirectory() as workdir:
        comp_launches, comp_references = compile_phase(torch, np, workdir, smi)
        for k in ("int8_head", "adadelta_delta"):
            check(comp_launches[k] > 0, f"the compile path never launched {k}")
        for name in ("fleet", "loadgen"):
            os.makedirs(os.path.join(workdir, name))
        fleet_launches, fleet_references = fleet_phase(torch, np, os.path.join(workdir, "fleet"),
                                                       os.path.join(workdir, "aot"))
        ih.LAUNCHES = 0
        loadgen_launches = loadgen_phase(torch, np, os.path.join(workdir, "loadgen"),
                                         os.path.join(workdir, "aot"), smi)
    check(fleet_launches["int8_head"] > 0, "the fleet path never launched int8_head")
    check(loadgen_launches["int8_head"] > 0, "the loadgen path never launched int8_head")
    top = by_n[str(TIMED_ROWS[-1])]
    kernels = [{
        "name": "int8_head", "route": "cuda",
        "source": "pytorch_mnist_ddp_tpu_torch/csrc/int8_head.cu",
        "replaces": "pytorch_mnist_ddp_tpu/ops/pallas_infer.py:61",
        "launches": (launches + stack_launches["int8_head"] + pool_launches["int8_head"]
                     + comp_launches["int8_head"] + fleet_launches["int8_head"]
                     + loadgen_launches["int8_head"]),
        "launches_by_phase": {"engine_server": launches,
                              "serving_stack": stack_launches["int8_head"],
                              "pool": pool_launches["int8_head"],
                              "compile": comp_launches["int8_head"],
                              "fleet": fleet_launches["int8_head"],
                              "loadgen": loadgen_launches["int8_head"]},
        "serving_stack_reference_launches": stack_references["int8_head"],
        "pool_reference_launches": pool_references["int8_head"],
        "fleet_reference_launches": fleet_references["int8_head"],
        "max_abs_err": max(kernel_err.values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        "rows": TIMED_ROWS[-1],
        "by_n": {n: {key: r[key] for key in ("ms", "back_to_back_ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "library_layout")}
                 for n, r in by_n.items()},
        "by_shape_n8": head_shapes,
    }]
    for name, t in ada_times.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pytorch_mnist_ddp_tpu_torch/csrc/adadelta.cu",
            "replaces": ADADELTA_REPLACES[name],
            "launches": (train_launches[name] + fused_launches[name] + ddp_launches[name]
                         + state_launches[name] + res_launches[name]
                         + comp_launches.get(name, 0)),
            "launches_by_phase": {**{phase: n[name] for phase, n in by_phase.items()},
                                  "fused": fused_launches[name], "ddp": ddp_launches[name],
                                  "train_state": state_launches[name],
                                  "resilience": res_launches[name],
                                  "compile": comp_launches.get(name, 0)},
            "fused_reference_launches": fused_references[name],
            "ddp_reference_launches": ddp_references[name],
            "train_state_reference_launches": state_references[name],
            "resilience_reference_launches": res_references[name],
            "compile_reference_launches": comp_references.get(name, 0),
            "max_abs_err": adadelta_err[name], **t,
        })
    train_shape = FLASH_MAIN["train"]
    for name, by_shape in flash_t.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pytorch_mnist_ddp_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": (vit_launches[name] + par_launches[name] + fam_launches[name]
                         + state_launches[name]),
            "launches_by_path": {"vit": vit_launches[name], "vit_parallel": par_launches[name],
                                 "vit_family": fam_launches[name],
                                 "train_state": state_launches[name]},
            "vit_parallel_reference_launches": par_references[name],
            "vit_family_reference_launches": fam_references[name],
            "train_state_reference_launches": state_references[name],
            "launches_bf16": vit_bf16_launches[name],
            "max_abs_err": max([*flash_err[name].values()]
                               + ([ring["max_abs_err"]] if name == "flash_partial" else [])),
            "max_abs_err_by_dtype": flash_err[name],
            **({"ring_max_abs_err": ring["max_abs_err"], "ring_per_hop": ring["per_hop"]}
               if name == "flash_partial" else {}),
            **by_shape[f"train {'x'.join(map(str, train_shape))}"],
            "shape": list(train_shape), "by_shape": by_shape,
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ddp_rank_program(sys.argv[2:]))
    if sys.argv[1:2] == ["--vit-rank"]:
        sys.exit(vit_rank_program(sys.argv[2:]))
    if sys.argv[1:2] == ["--state-rank"]:
        sys.exit(state_rank_program(sys.argv[2:]))
    if sys.argv[1:2] == ["--fused-rank"]:
        sys.exit(fused_rank_program(sys.argv[2:]))
    if sys.argv[1:2] == ["--compile-cli"]:
        sys.exit(compile_cli_program(sys.argv[2:]))
    if sys.argv[1:2] == ["--compile-serve"]:
        sys.exit(compile_serve_program(sys.argv[2:]))
    sys.exit(main())
