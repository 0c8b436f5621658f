#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``theanompi_tpu_torch``) on the card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. build      — compile every kernel of the paths (``csrc/*.cu``: the
                fused update, the quantizer, flash attention, the pool) with nvcc
                for sm_90a, one nvcc per source, all started together;
                print the build's wall time. Proof of design: the SASS of
                ``flash_fwd_sm90_kernel``, ``flash_dq_sm90_kernel`` and
                ``flash_dkv_sm90_kernel`` (``cuobjdump -sass`` of the
                built library) must hold HGMMA
                (wgmma) and UTMALDG (TMA loads), that of
                ``flash_fwd_mma_kernel``, ``flash_dq_mma_kernel`` and
                ``flash_dkv_mma_kernel`` HMMA (mma.sync) and LDGSTS
                (cp.async), and both instantiations
                of ``flash_fwd_mma_bf16_kernel``, ``flash_dq_mma_bf16_kernel``
                and ``flash_dkv_mma_bf16_kernel`` HMMA and LDSM (ldmatrix),
                the cp.async ones LDGSTS too (the staged dk/dv one as well:
                its lse and dsum come by cp.async); their registers, shared
                memory and spills are printed (``cuobjdump
                --dump-resource-usage``). ptxas's registers, stack and
                spills of each instantiation of the fused update's
                multi-tensor kernel, of the block codec's multi-leaf
                kernel and of the two halo-tile pool kernels, with their
                static shared memory (``nvcc -Xptxas -v``).
2. kernels    — the fused update's multi-tensor kernel (#1-2, one launch
                over a whole leaf list per dtype group) against its plain
                PyTorch version, one call over each list: AlexNet's 16,
                GoogLeNet's 128, WRN-28-10's 80, ResNet-50's 161 and
                VGG16's 32 parameter leaves (from the port's models, the
                leaf sets every main path gives the kernel), each in fp32 params with fp32 grads, bf16 params with bf16
                and with fp32 grads, conv leaves in the default layout and
                in channels_last (the main path's); and an edge list of 12
                leaves mixing the three dtype pairs, with views 4 bytes off
                a 16-byte boundary (p, v or g), lengths 1, 7, 0, odd and
                past one chunk; there the whole buffers around the views
                must match too. Momentum, Nesterov and sgd; clip off /
                norm under / norm over the limit. Tolerance: fp32 params
                and every fp32 velocity bit-identical; bf16 params within
                1 bf16 ulp. Launch counters must move by the launches the
                work table asks for (one per dtype group), not one per
                leaf.
   quant      — the int8 quantizer kernels (#3–6) against their plain
                versions on the card, bit-identical (int8 values, f32
                scales with NaN where the plain version has NaN, decoded
                values): AlexNet's 16 leaf lengths padded to (rows, 128),
                lengths 1, 127 and 129, and rows that are zero, hold a NaN,
                an inf, denormal magnitudes, or values on exact half steps
                of a power-of-two scale; the ring's fused decode-and-add;
                ``wire_encode``'s message byte-identical to the plain
                version's (a NaN scale's payload aside) and its decode.
                Then the block codec's multi-leaf launch (#3-4, one launch
                a list): AlexNet's 16 flat leaves, lengths 1, 127, 128, 129
                and 34,848 in one list, leaves with a NaN row, an inf and a
                NaN in a 1-element last row, a list split at a table
                capacity of 2 (two launches), the dequantize into outputs
                and into padded accumulators; values (4 bytes off a
                16-byte boundary), scales and outputs sit between guard
                rows and elements that must not move. A misaligned leaf
                is refused. Counters move by one a list (two for the
                split). Last, #5's one-launch kernel and the three-pass
                launcher it replaced, bit for bit, over buffers past the
                50 MB L2: a codec round's 476,292 rows (244 MB) and
                131,071 rows (67 MB, an odd count), the latter also with
                a NaN, with +inf and -inf, and with -inf alone; each
                counter moves by one a call.
   flash      — each flash attention kernel (#7-11: flash_fwd_sm90,
                flash_fwd_mma, flash_fwd_mma_bf16 and flash_fwd,
                flash_dq_sm90, flash_dq_mma, flash_dq_mma_bf16 and
                flash_dq,
                flash_dkv_sm90, flash_dkv_mma, flash_dkv_mma_bf16 and
                flash_dkv) against its plain version on
                the card: the 136M LM's shape (BH 96, T 1024, D 64) in bf16
                and fp32, the 350M LM's (BH 128) in bf16, ragged T and D, Tq != Tk, causal and not, nonzero
                offsets with rows that see no key (o = 0, lse ~ -1e30), Tq
                200 and 1000 at D 64 (not multiples of the 128-row Q tile),
                q_off 160 over Tq 200 / Tk 360, bf16 heads of 60, 36 and 33
                (no whole 16-byte rows; 33 odd: register-staged loads) with
                ragged T and offsets, and for the bf16 dq and dk/dv of such
                heads a sweep over D 1 to 63 at five shapes (ragged, Tq !=
                Tk, blind rows), causal and not, aligned and from views one
                element off, fp32 heads of 30 and 33 (4-byte
                copies) and the same sweep of the fp32 dq, and T = 8192
                (BH 2, bf16). The counters show
                each case's forward, dq and dk/dv routes: bf16 with D % 8 ==
                0 runs flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90,
                fp32 flash_fwd_mma, flash_dq_mma and flash_dkv_mma (each
                3xTF32), the other bf16 heads flash_fwd_mma_bf16,
                flash_dq_mma_bf16 and flash_dkv_mma_bf16. The generic
                flash_fwd, flash_dq and flash_dkv, which no route takes,
                are held to the same limits through their own launchers
                on those bf16 heads, and the generic flash_dq on every
                fp32 case. Tolerances: fp32 o rtol
                1e-5 + 1e-6 max|o|, dq/dk/dv
                rtol 1e-4 + 1e-5 of the largest value; bf16 o within 1 bf16
                ulp plus 2^-9 of sum_i p_i |v_i| / l (the tensor cores sum
                q.k in another order, so a p near a bf16 rounding boundary
                can round to its neighbour on one side: see
                ``bf16_o_excess``), dq/dk rtol 1e-4 + 2^-9 of the largest
                value (likewise one ds), dv (p unrounded; flash_dkv_sm90
                and flash_dkv_mma_bf16 split p into three exact bf16
                parts) at the fp32 limit
                rtol 1e-4 + 1e-5 of the largest value, which a dv from
                bf16(p) must fail; lse atol 1e-5. The routes' forward, dq
                and dk/dv counters move by one per case. The ring hops of
                the 136M LM at --sp 4 (BH 96, Tq = Tk = 256, D 64, bf16,
                causal) at (q_off, k_off) (512, 256), (512, 512) and (256,
                512), and the same three in fp32 and at D 60 (BH 4): the
                last is a hop wholly in the future, where no CTA of any
                route has a tile; o, dq, dk and dv must be exactly 0 there
                (the kernels' and the plain versions') and lse <= -1e29.
   pool       — the 3x3/s1 max pool kernels (#12 maxpool3x3_fwd, #13
                maxpool3x3_bwd) against their plain versions, bit for bit
                (a NaN matches any NaN), in fp32 and bf16, at the distinct
                inception pool inputs of GoogLeNet at batch 512 ([512, 28,
                28, 192 / 256], [512, 14, 14, 480 / 512 / 528], [512, 7, 7,
                832]), the reference tests' (2, 8, 8, 16) and (3, 7, 5,
                130), shapes that cut the halo tile ((4, 29, 31, 72): a
                ragged band and width; (2, 64, 64, 64): the widest map
                ``routable`` admits, two column tiles; (3, 1, 1, 8)), and
                (2, 14, 14, 64) from views one element past a 16-byte
                boundary (the one-channel-a-word path): random, tie-heavy
                (ReLU zeros, a few levels) and NaN/+-inf inputs. Control:
                select-and-scatter's gradient
                (F.max_pool2d's backward, first maximum) on tie-heavy input
                must fail the backward check. Each counter moves by one
                per call.
   feed       — the input feed's host side. The port's native loader
                (``native/loader.cpp``) built with this host's g++, and
                ``gather_rows`` (from a memory-mapped shard),
                ``crop_mirror_u8`` and ``crop_mirror_normalize`` (scalar,
                per-channel and 227x227 plane means) held bit for bit
                against their numpy versions over a 256-row batch of
                256x256x3 images cropped to 227, at 1 thread and at the
                default count; the card's ``(x.float() - mean) * scale``
                (``train.make_input_transform``) bit for bit against the
                CPU's. Then the host batch (AlexNet's: 128 rows at 227)
                of three feeds, median of 11 after one left out
                (``tools/profile_step.py::feed_times``): float32
                ``synthetic``, uint8 ``imagenet_synthetic`` and
                ``imagenet`` over 256x256x3 shards that ``write_shards``
                writes to a temporary directory (2,816 + 128 images, also
                phase feed-main's), each as gather, crop, pin and H2D ms;
                every feed (float32 too, since the native gather takes
                any fixed-width dtype) both written into pinned memory as
                the training loop does (``data/loader.py::pinned_array``)
                and into fresh arrays then pinned (the reference's order).
                Last, host ms medians: the native gather of float32 rows
                (128 of 227x227x3) and of int32 windows (8 of 1024) fresh,
                into pinned memory and by numpy's fancy index (bit for bit
                equal), and the crop of 128 rows with every image
                mirrored, none and half, numpy's, and the normalizing crop
                mirrored and not.
3. main       — the training path a user runs, through
                ``theanompi_tpu_torch.cli.main``: full-width AlexNet (batch
                128, 227x227x3, 1000 classes, bf16 compute, fp32 params,
                random weights from a seed) for 10 steps with
                ``--fused-update`` (momentum recipe), then 3 steps of the
                same model under an sgd recipe with ``--wire-codec
                int8:ef``, which one card must ignore (no collective and
                no codec, as the reference's one-device path). Counters are
                zeroed just before each run and read just after: one
                launch of the run's update kernel per step (one dtype group
                of 16 leaves), none of any other kernel. Then 12 steps on
                uint8 ``imagenet_synthetic`` at ``--dispatch-depth 1``, at
                depth 3 and at the default, in turns (default, 1, 3, 1,
                default): the same JSONL rows every run, as many steps in
                flight as the depth (depth 3 reads rows while newer steps
                run), the step times printed.
4. bsp-ranks  — multi-rank BSP of the same model through the CLI: global
                batch 128 split over the ranks, 6 steps, ``--fused-update
                --strategy psum --wire-codec int8:ef``. With one card: 2
                ranks on cuda:0 over gloo (NCCL refuses two ranks on one
                card); with 2 or more: NCCL over 4 cards (2 when fewer than
                4), and ``--strategy ring_int8`` too. Each rank counts its
                own launches from 0: per step one fused_momentum, and under
                the codec one quant_block and one dequant_block over all 16
                leaves; under ring_int8 at n ranks n and 2n-1. Losses finite; params and velocities
                bit-identical across ranks (digests); each rank's
                error-feedback residual nonzero and its own.
   bsp-exchange — the rest of the BSP exchange, one spawn of the ranks,
                every run through ``run_training`` (the CLI's per-rank
                entry point) with the counters zeroed just before it: (a)
                full-width ResNet-50, global batch 64 a rank of uint8
                ``imagenet_synthetic``, ``--fused-update``, psum in 25 MB
                buckets, with ``bn_axis_name=data`` (cross-replica BN) and
                without it; (b) full-width AlexNet (128) over 2 slices:
                flat psum, hier, hier with int8:ef; (c) AlexNet under
                psum + int8:ef, ring_int8, 25 MB buckets and buckets +
                int8:ef. With 4 cards (NCCL, one a rank): 8 steps, (a)
                and (c) also in captured groups of 4, which must equal
                the eager runs bit for bit (losses, replica, residual and
                BN digests; (a)'s last checkpoint's 106 BN entries), and
                (d) where the step goes under psum, buckets and hier, in
                turns: eager and captured step ms per rank (CUDA events)
                and the NCCL kernels' device ms (``torch.profiler``; the
                rank that arrives last reads the exchange's own time). With one card: 2 ranks on
                cuda:0 over gloo, 4 steps, eager only; a captured group
                of gloo ranks must be refused; what could not run is
                printed. Every run: finite losses, params, velocities
                and BN statistics equal on every rank; per step one
                fused_momentum, quant_block and dequant_block one each
                under hier + int8:ef and psum + int8:ef, one each a
                bucket under buckets + int8:ef, n and 2n-1 under
                ring_int8, none otherwise; residuals nonzero and each
                rank's own. (a)'s trajectory differs from per-replica
                BN's; (b)'s hier is within 1e-2 of psum (losses
                relative, the params' change in relative norm).
                ``python3 chip_smoke.py --only bsp-exchange`` builds the
                two kernels it needs and runs this phase alone.
   rules      — Theano-MPI's other two rules (``parallel/easgd.py``,
                ``parallel/gosgd.py``), one spawn of the ranks, every run
                through ``run_training`` with the counters zeroed just
                before it, ``--fused-update``, uint8
                ``imagenet_synthetic``, each worker its recipe's batch.
                With one card: 2 ranks on cuda:0 over gloo, eager, 4
                steps of full-width AlexNet under EASGD (``--avg-freq 2
                --wire-codec int8:ef``: 2 exchanges) and GoSGD
                (``--wire-codec int8 --p-push 1``: a round a step). With
                4 cards (NCCL, ``--only rules``): ResNet-50 under EASGD
                (config #4's shape: 4 workers of 256, ``--avg-freq 8``,
                16 steps, 8 an epoch) eager and in captured groups of 4,
                which must be equal bit for bit (losses, validation,
                worker, center and BN digests), the same in 2 workers of 2
                cards (``--group-size 2``, BN over the group), and VGG16
                under GoSGD (config #5's shape: 4 workers of 256, p 0.25)
                with no codec and int8. Every run, on every rank: finite
                losses; one fused_momentum a step; under int8 one
                quant_block and one dequant_block an exchange or round
                (none without a codec); the exchanges or rounds counted;
                the workers' digests distinct and a group's equal; after
                EASGD's last exchange one center on every rank; GoSGD's
                shares summing to 1; the local step's and the exchange's
                or round's median ms per rank and the slowest round (the
                device's timeline), printed with the card's name and
                power limit. The one-card GoSGD run and the 4-card
                grouped eager ResNet-50 run write their checkpoint, which
                must hold every worker's distinct row at the run's step.
   lm-main    — full-width TransformerLM_136M (12 layers, d 768, 12 heads
                of 64, T 1024, vocab 32768, batch 8, bf16 compute, Adam,
                random weights from a seed) through the CLI for 6 steps
                and one validation batch: exactly 12 x 7 flash_fwd_sm90,
                12 x 6 flash_dq_sm90 and flash_dkv_sm90 launches, no
                flash_fwd, flash_fwd_mma, flash_fwd_mma_bf16, flash_dq,
                flash_dq_mma, flash_dq_mma_bf16, flash_dkv, flash_dkv_mma
                or flash_dkv_mma_bf16, no other kernel;
                losses finite; step ms and tokens/s.
   lm350-main — full-width TransformerLM_350M (24 layers, d 1024, 16 heads
                of 64, d_ff 4096, T 1024, vocab 32768, batch 8, bf16, Adam,
                per-block remat) through the CLI for 4 steps and one
                validation batch: exactly 24 x (2 x 4 + 1) flash_fwd_sm90
                (remat runs each block's forward again in the backward),
                24 x 4 flash_dq_sm90 and flash_dkv_sm90, no other kernel;
                losses finite; step ms, tokens/s, peak allocated memory.
   sp         — sequence parallelism (``parallel/nd.py``, ``--sp``): the
                136M LM's width (d 768, 12 heads of 64, T 1024, vocab
                32768, batch 8, bf16, Adam) at 2 layers, 2 gloo ranks on
                cuda:0 at --sp 2 through ``run_training`` (the successor
                table of the synthetic chain drawn once here and handed
                to the ranks), 3 steps and one validation batch, under
                ring_flash and under ulysses_flash with --wire-codec
                int8:ef: each rank launches exactly 2 (ring) or 1
                (Ulysses) x 2 layers x (3 + 1) flash_fwd_sm90 and x 3
                flash_dq_sm90 and flash_dkv_sm90, under the codec 3
                quant_block and 3 dequant_block, no other kernel; losses
                finite and equal across the ranks, the replicas equal;
                the first step's loss within rtol 1e-3 of one rank's
                (attn flash) from the same weights and batch.
                ``--only sp`` on 4 cards (NCCL, one rank a card): the
                12-layer 136M at --sp 4 under ring_flash and
                ulysses_flash and at data 2 x seq 2 (ring_flash), each 32
                steps eager and in captured groups of 4, eager = captured
                bit for bit (replicas and losses); step ms over the 30
                steady steps, tokens/s; the eager run cut at step 16 and
                resumed, ending on its state; the 350M with remat at
                --sp 4 for 4 steps; T 8192 at batch 2 at --sp 4 beside
                --sp 1 on one card, peak memory a card; and a profile
                (``torch.profiler``) of 5 steps at --sp 4 of each scheme:
                NCCL's, the flash kernels' and the other kernels' device
                time a step.
   tp         — tensor parallelism (``parallel/nd.py``, ``--tp``): the
                136M LM's width at 2 layers, 2 gloo ranks on cuda:0 at
                --tp 2 (each rank 6 of the 12 heads, 1536 of the 3072
                hidden units, 16384 of the 32768 vocabulary columns; the
                ranks spawned once with phase sp's), 3 steps and one
                validation batch, plain and with --wire-codec int8:ef:
                each rank launches exactly 2 layers x (3 + 1)
                flash_fwd_sm90 and 2 x 3 flash_dq_sm90 and flash_dkv_sm90
                (at B x H / tp), under the codec 3 quant_block and 3
                dequant_block (one round a step over the replicated
                leaves, which cross the model axis; the tp-sharded leaves
                have no wire there and their residuals stay 0), no other
                kernel; losses finite and equal across the ranks, each
                model index's shards equal, the replicated leaves equal on
                both; the first step's loss within rtol 1e-3 of phase
                sp's one rank (attn flash, the same weights and batch).
                ``--only tp`` on 4 cards (NCCL, one rank a card): the
                12-layer 136M at --tp 4, data 2 x tp 2 (attn flash) and
                tp 2 x seq 2 under ring_flash and ulysses_flash, each 32
                steps eager and in captured groups of 4, eager = captured
                bit for bit; step ms over the 30 steady steps, tokens/s,
                peak memory a card; the --tp 4 run cut at step 16 and
                resumed, ending on its state; a --tp 2 file (int8:ef)
                restored onto --tp 4 through ``load_resharded``, params
                and Adam's state bit for bit the file's and the residuals
                zero, then resumed with ``--elastic`` at --tp 4; the 350M
                (remat, no loss_chunk) at --tp 4 for 4 steps.
   googlenet-main — full-width GoogLeNet (224x224x3, 1000 classes, both
                aux heads, bf16 compute, fp32 params, momentum 0.9, wd
                1e-4, poly, batch 512, random weights from a seed) through
                the CLI with ``--pool-kernel --fused-update`` for 6 steps
                and one validation batch: exactly 9 x 7 maxpool3x3_fwd,
                9 x 6 maxpool3x3_bwd and 1 x 6 fused_momentum launches,
                no other kernel; losses finite; peak memory. Then the same
                command without ``--pool-kernel``: no pool kernel launch.
                Both step times, and the device step of both with the
                batch resident, in turns (on, off, on, off).
   feed-main  — the feed through the CLI, long enough to drain the
                prefetch queue: full-width AlexNet with ``--fused-update``
                on ``--dataset imagenet_synthetic`` and on ``--dataset
                imagenet`` (the shards of phase feed, 10-crop validation),
                22 steps (20 steady), and GoogLeNet at batch 512 on
                ``imagenet_synthetic`` with ``--pool-kernel
                --fused-update``, 14 steps (12 steady). Kernel counters and
                the native loader's call counts zeroed just before each run
                and read just after: one fused_momentum a step, for
                GoogLeNet also 9 maxpool3x3_fwd a step and a val batch and
                9 maxpool3x3_bwd a step, nothing else; at least one native
                gather a step (and crop, on the shards). Losses and val
                metrics finite, batches uint8 normalized on the card,
                10 views a validation image on the shards. Each run's step
                against the same model's step with a uint8 batch resident
                on the card (twice), and the host time the loop waited on
                the loader a step.
   e2e        — ``tools/bench.py --mode e2e``: full-width AlexNet (227
                crop of 256x256 uint8 shards written from a seed, batch
                128, ``--fused-update``) trained 48 steps through
                ``run_training`` at dispatch depths 1 and 2, then a clean
                checkpointed run against one crashed at step 24 and resumed
                by the supervisor: every dispatched step executed, one
                fused_momentum a step and no other kernel in each run, a
                native gather and crop a step, exactly one retry; the JSON
                row (img/s, step and wait ms, wait and host-blocked shares,
                mfu, recovery overhead).
   scaling    — ``tools/bench.py --mode scaling``: the fixed-work probe
                (Cifar10_model at a total batch of 512, best of 3 trials
                of 96 steps) at 1 and 2 ranks (one card: 2 gloo ranks on
                it); ``--only scaling`` on 4 cards: NCCL at 1, 2 and 4
                ranks and flat psum against hier over 2 slices at 4.
                Replica digests equal on every rank; img/s and t(1)/t(n).
   resume     — checkpoint, resume and the supervisor through the CLI at
                AlexNet's full width (``--synthetic --fused-update``, 2
                steps an epoch: saves at steps 2, 4 and 6). One card: 6
                steps without a break (the control, async writer);
                a supervised run (``--max-retries 2 --inject-fault
                bitrot@4 --inject-fault crash@5``): the crash leaves no
                newer save, the retry's scrub quarantines ``ckpt_4``, its
                record names step 2, and the retried run loads ckpt_2's
                state (the digest a save of it records) with its dropout
                generator, 4 + 4 launches of #1 over both attempts; the
                preemption pair (``--max-retries 1 --sigterm-grace 30
                --inject-fault sigterm@3 --sync-ckpt --fault-ledger``):
                exit 75 with ``resumable.json`` at step 3, then the same
                command resumes by itself (digest, generators, 3
                launches). 2 ranks on cuda:0 over gloo with psum +
                int8:ef: the control; ``--sync-ckpt --max-retries 1
                --inject-fault crash@5`` (gathered files, no crash save):
                the retry resumes from ckpt_4 (record, digest,
                generators; #1, #3 and #4 4 + 2 a rank over the
                attempts, both ranks' counts of attempt 1 on record);
                ``--ckpt-sharded --max-retries
                1 --inject-fault crash@4`` (under ``--only resume``; the
                default run leaves it to the shrink below, whose first
                attempt writes the same kind of set, to pay for phase
                sp): each rank's crash save makes
                one member of step 3's set, the retry resumes from it
                (digest, generators; #1, #3 and #4 3 + 3 a rank over the
                attempts); ``--ckpt-sharded --elastic --max-retries 1
                --inject-fault shrink@4:1``: the retry runs one rank,
                resharded from 2 (the params the set's bit for bit, the
                16 residual leaves reset, the generators restarted; #3 /
                #4 3 a rank, then none). Every final checkpoint (params,
                velocities, step, residuals, generator states; a set
                reassembled) equals the control's bit for bit, whether
                its run wrote async or ``--sync-ckpt``. Prints the file
                size, the saves, the loads, the reshard and each retry's
                time from the failure to its first step, in parts.
                ``--only resume`` runs this phase alone; on 4 cards
                (NCCL) only the shrink from 4 ranks to 2 (``shrink@4:2``,
                sharded), with the same checks.
5. parity     — the same small AlexNet (67x67, fp32, dropout off) trained 2
                steps on the card and on the CPU (where the wrappers run
                their plain versions) from the same weights and batches.
                Losses agree within rtol 1e-3. Each leaf's velocity agrees
                within rtol 1e-3 plus 2e-3 of its largest value: cuDNN's
                fp32 weight gradient of conv2 at this geometry is off by
                about 8e-4 of its largest value against float64
                (``tools/conv_precision.py --size 67``), the CPU's by 1e-6.
                So does its parameter change (after - before), plus 2 fp32
                ulps of the parameter: a change far smaller than the
                parameter is rounded at each of the 2 writes. Every leaf
                changed on the card.
   lm-parity  — a small fp32 LM (2 layers, d 128, 2 heads of 64, T 256,
                vocab 512, batch 4, Adam, attn flash) trained 2 steps on the
                card and on the CPU from the same weights and batches:
                losses within rtol 1e-4, params within atol 1e-6 + rtol
                1e-4, every leaf changed, 4 launches of each fp32 flash
                kernel (flash_fwd_mma, flash_dq_mma, flash_dkv_mma), none of
                another. Then the same in bf16 compute with heads of 60
                (d 120, 2 heads): 4 launches each of flash_fwd_mma_bf16,
                flash_dq_mma_bf16 and flash_dkv_mma_bf16, none of
                another; losses within
                rtol 2e-2 (bf16 products round in other places on the
                two devices), every leaf changed, and the card's
                parameter change within 0.1 of the CPU's in relative norm.
   remat-parity — a 2-layer bf16 LM (d 128, 2 heads of 64, T 256) trained
                2 steps on the card with remat and without, and on the CPU
                with remat: losses within rtol 2e-2 and the card's remat
                parameter change within 0.1 (relative norm) of the CPU's
                and of no remat's (lm-parity's bf16 limits), 8 / 4
                flash_fwd_sm90 and 4 flash_dq_sm90 / flash_dkv_sm90
                launches; whether remat equals no remat bit for bit is
                printed. Then the 350M class at that width through the CLI,
                6 steps eager against ``--steps-per-dispatch 2`` (the remat
                step captured in a CUDA graph): losses, validation and
                replica digests bit for bit.
   googlenet-parity — full-width GoogLeNet (224x224x3, 1000 classes, fp32,
                dropout 0, pool kernel on, lr 0.001) trained 2 momentum
                steps on the card and on the CPU from the same weights and
                batches: the train-mode logits at the start within rtol
                1e-4 + 1e-4 of their largest value, losses rtol 1e-4, each
                leaf's velocity and parameter change within 1e-1 of its
                norm, every leaf changed, 27 / 18 / 2 launches. Not
                phase parity's elementwise 2e-3: the gradient of this
                network is not continuous in its weights (a ReLU or a
                pool's maximum flips under a rounding change), and on the
                CPU 1e-6 relative noise on the weights alone moves the
                velocities after 2 steps by 4.2e-2 of their norm and
                6.3e-2 of a leaf's largest value.
   graph      — step fusion: full-width AlexNet (batch 128, uint8
                ``imagenet_synthetic``, ``--fused-update``), TransformerLM_136M
                (batch 8, T 1024) and GoogLeNet at batch 512 (uint8,
                ``--pool-kernel --fused-update``) each through the CLI
                twice over the same 14 steps (8 an epoch, a validation
                batch after each epoch): eagerly, and with
                ``--steps-per-dispatch 4``, whose steps replay one captured
                CUDA graph of the step (groups 4 4 | 4 2). Counters zeroed
                just before each run and read just after. Each pair must
                be bit-identical (every loss, the validation metrics, the
                digest of the final params and velocities), launch every
                kernel the same number of times (the capture's launches
                added back at each replay), and the grouped run must have
                made 1 capture and 13 replays. Both CLI step times; then
                ``tools/bench.py``'s compute mode of each model, eager and
                captured (its JSON line), whose last losses must agree.
                Last, full-width AlexNet with every leaf of its state
                replaced between two groups must be captured again (2
                captures, 3 replays) and equal 4 eager steps bit for bit.
   zoo-main   — the rest of the CNN zoo through the CLI, counters zeroed
                just before each run and read just after, with finite
                losses and validation, step ms (CUDA events, 2 warm-up
                steps left out), img/s and peak memory: WRN-28-10
                (BASELINE config #1: 32x32x3, 10 classes, fp32, Nesterov,
                batch 128, ``--synthetic --fused-update``) over 14 steps
                of 8 an epoch eagerly and with ``--steps-per-dispatch 4``,
                bit-identical (losses, val, digest, and the 50 BN
                statistics of each run's final checkpoint), with equal
                counts: fused_momentum (nesterov=1)
                ``update_launches(80)`` a step and no other kernel; then 3
                steps and ``--resume`` to 6, whose final checkpoint must
                equal an uninterrupted 6-step run's entry for entry, BN
                statistics included. ResNet-50 at 256 and VGG16 at 128
                (224x224x3, 1000 classes, bf16) on uint8
                ``imagenet_synthetic`` with ``--fused-update``, 6 steps
                each; the cifar10 CNN and the MLP, 3 steps each. Last,
                WRN-28-10 and AlexNet at their ``zoo_entry`` batch (1024
                each), 2 steps with the batch resident: their peak
                memory.
   zoo-parity — WRN-28-10 at full width (fp32, batch 8, Nesterov at lr
                0.01) 2 steps on the card (cuDNN, kernel #1) and on the
                CPU (the plain versions) from the same weights and
                batches: the first training forward's logits and BN
                statistics within rtol 1e-4 + 1e-4 of their largest
                value, losses rtol 1e-4, and after 2 steps the param
                changes and velocities per leaf in relative norm 1e-1
                (phase googlenet-parity's limit; the kernel itself is held
                bit for bit at WRN-28-10's leaves in phase kernels), the
                BN statistics in 1e-3. ResNet-50 at full width in bf16
                (batch 4): each top-level layer fed the CPU's own input
                within 2^-5 of the largest value of its output and
                statistics; the whole training forward's logits within
                the CPU's own spread under a one-ulp input change (the
                worst of 3 seeded draws), and its loss rtol 2e-2.
   zoo-bench  — ``tools/bench.py`` (``--fused-update``) of WRN-28-10 at
                128, ResNet-50 at 256 and VGG16 at 128, eager and
                captured, printed as ``[zoo] bench {...}`` lines; the
                pair's last losses must agree.
6. times     — #1-2 per optimizer step over AlexNet's 16 and GoogLeNet's
                128 fp32 leaves, in turns (A B C D, twice): the wrapper,
                the same launch with its table built once (the device's
                time alone), the per-leaf launches it replaced
                (``tools/update_variants.py``) and ``torch.optim.SGD(fused=
                True)``; the host's microseconds per ``Optimizer.apply``,
                the fused one and the replaced one in turns. #3-4 per
                codec round over AlexNet's 16 leaves in turns: the
                wrapper (one launch), its table built once, the
                codec's former 16 one-leaf calls, for #4 one
                ``torch.mul`` over the round's buffers (and per leaf);
                the host's microseconds per round. #5-6 per round,
                #6 in turns with ``torch.mul``; then each over ONE
                buffer of the round's elements: #5's one launch in turns
                with the three-pass launcher it replaced (old, new, new,
                old), #6 with ``torch.mul``. Each: time (CUDA events), its bound
                (bytes / memory rate vs operations / fp32 peak, the larger;
                #1-2 count the scalar block once per real launch), the
                plain version's time, and a PyTorch yardstick where one
                call computes the same function. Each flash kernel per
                launch at the 136M shape (bf16, causal): bound from bytes
                and from operations (bf16 products at the bf16 tensor-core
                peak, flash_dkv's fp32 dv product at the fp32 peak;
                flash_dkv_sm90's split dv product as three bf16 products),
                and SDPA's causal forward / backward as the yardstick; the
                generic bf16 flash_fwd, flash_dq and flash_dkv (through the
                module's own launchers) and flash_fwd_sm90 / flash_dq_sm90
                / flash_dkv_sm90 in turns (old, new, new, old). At D 60
                (BH 96, T 1024, bf16, causal): the generic flash_fwd,
                flash_dq and flash_dkv each in turns with the kernel that
                took its place there (flash_fwd_mma_bf16,
                flash_dq_mma_bf16, flash_dkv_mma_bf16), SDPA's forward and
                backward at D 60. In fp32 at the 136M
                shape: flash_fwd_mma, flash_dq_mma and flash_dkv_mma
                each in turns with the generic kernel's fp32
                instantiation, and SDPA's fp32 forward and backward. The
                pool kernels over the nine inception pools at batch 512
                in bf16 (one step's launches): bound 2 (forward) or 4
                (backward) bf16 tensor passes at the data sheet's memory
                rate and at the card's copy rate, measured once here
                (``dst.copy_(src)`` over 2 GB, read + write bytes; a
                yardstick, not a kernel of the port); F.max_pool2d in
                channels_last as the yardstick (its backward takes the
                first maximum).

   capture-failure — last: a step with a host sync (``float()`` of a
                card tensor) must make the graph runner raise
                ``GraphCaptureError`` naming that line, with no replay.

A ``[feed]`` line sums up both feed phases as JSON. Then one JSON line
``{"kernels": [...]}``, the card's name and power
limit as nvidia-smi prints them, and last ``{"ok": true, "device": ...}``.
Exits 2 without a card, or when run outside a checkout of the repo.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# card name -> (memory rate B/s, fp32 peak outside the tensor cores FLOP/s,
# bf16 dense tensor-core peak FLOP/s, tf32 dense tensor-core peak FLOP/s:
# half the sheet's 989 with sparsity), from NVIDIA's data sheet: the H100
# SXM5 80 GB. Another card has other rates, so the script refuses it
# rather than compute its bounds wrongly.
CARD_RATES = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12, 989e12, 494.7e12)}

MAIN_STEPS = 10
SGD_STEPS = 3
RANK_STEPS = 6
LM_STEPS = 6
LM_VAL = 8  # one validation batch of 8 windows
LM_LAYERS = 12
# the 136M LM's attention shape: batch 8, T 1024, 12 heads of 64
LM_SHAPE = dict(B=8, T=1024, H=12, D=64)
# the 350M LM's: batch 8, T 1024, 16 heads of 64
LM350_SHAPE = dict(B=8, T=1024, H=16, D=64)
# full-width GoogLeNet: the repo's single-card batch, steps of its main run
GNET_BATCH = 512
GNET_STEPS = 6
FULL_WIDTH = ["--dataset-arg", "image_shape=[227,227,3]", "--dataset-arg", "n_classes=1000"]
# phase resume: steps a run and an epoch (saves at steps 2, 4 and 6; the
# preemption at step 3 and the crash saves at step 3 land mid-epoch)
RESUME_STEPS = 6
RESUME_EPOCH = 2
# phase main's dispatch-depth runs: steps a run (2 warm-up steps left out)
DISPATCH_STEPS = 12


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv, want_rc: int = 0):
    """``theanompi_tpu_torch.cli.main(argv)``; returns its summary (the
    last stdout line), echoing the run's output. The exit code must be
    ``want_rc`` (75: a preempted run)."""
    from theanompi_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, buf)):
        rc = cli.main(argv)
    check(rc == want_rc, f"cli.main returned {rc}, expected {want_rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ulp_distance_bf16(a, b):
    """Max distance in bf16 units in the last place (sign-aware)."""
    import torch

    def key(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((key(a) - key(b)).abs().max().item())


def alexnet_leaf_shapes():
    import torch
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.tree import tree_leaves

    model = AlexNet()
    params, _ = model.net.init(torch.Generator().manual_seed(0), model.input_shape)
    return [tuple(p.shape) for p in tree_leaves(params)]


def update_launches(n_leaves: int) -> int:
    """Launches of the fused update a step over ``n_leaves`` leaves of one
    dtype group: one, unless the work table outgrows the kernel-parameter
    limit the library was built for."""
    from theanompi_tpu_torch.ops import fused_update as fu

    return -(-n_leaves // fu._LIB.get().tmpi_fused_table_capacity())


def edge_leaves(dev, gen):
    """A leaf list of the edge cases, its dtype groups mixed in one call:
    (p buffer, v buffer, g buffer, offsets of p, v and g in elements,
    length). Offsets of 4 bytes leave a pointer off its 16-byte boundary;
    lengths of 1 and 0, odd and not a whole number of 8-element groups."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    n = 1_000_003
    specs = [(f32, f32, 0, 0, 0, n), (f32, f32, 1, 0, 0, n), (f32, f32, 0, 1, 0, 4099),
             (f32, f32, 0, 0, 1, n), (f32, f32, 0, 0, 0, 1), (f32, f32, 0, 0, 0, 0),
             (bf16, bf16, 0, 0, 0, n), (bf16, bf16, 2, 0, 0, n), (bf16, bf16, 0, 0, 2, 8191),
             (bf16, f32, 2, 1, 1, n), (bf16, f32, 0, 0, 0, 7), (bf16, bf16, 0, 0, 0, 1)]
    out = []
    for pd, gd, po, vo, go, length in specs:
        def buf(scale, dt, off):
            return (torch.randn(length + 8, generator=gen, device=dev) * scale).to(dt), off
        out.append((buf(0.01, pd, po), buf(1e-3, torch.float32, vo), buf(1e-2, gd, go), length))
    return out


def edge_copy(bufs):
    """Fresh copies of the edge list's p and v buffers -> (the buffers,
    the p views, the v views)."""
    whole = [(p.clone(), v.clone()) for (p, _), (v, _), _, _ in bufs]
    pv = [p[po:po + n] for (p, _), ((_, po), _, _, n) in zip(whole, bufs)]
    vv = [v[vo:vo + n] for (_, v), (_, (_, vo), _, n) in zip(whole, bufs)]
    return whole, pv, vv


def phase_kernels(leaf_sets, dev):
    """The multi-tensor kernel against its plain version, over whole leaf
    lists in one call each: every model's leaves in every dtype and
    layout case, and the edge-case list."""
    import torch
    from theanompi_tpu_torch.ops import fused_update as fu

    cap = fu._LIB.get().tmpi_fused_table_capacity()
    check(cap in (fu.table_capacity(), fu.table_capacity(4096)),
          f"the library's work table holds {cap} leaves; ops/fused_update.py's layout gives "
          f"{fu.table_capacity()} (CUDA >= 12.1) or {fu.table_capacity(4096)}")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"fused_momentum": 0.0, "fused_sgd": 0.0}
    worst_ulp = 0
    launches_seen = {}
    dtype_pairs = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                   (torch.bfloat16, torch.float32))
    cases = [(name, specs, pd, gd, layout) for name, specs in leaf_sets for pd, gd in dtype_pairs
             for layout in (torch.contiguous_format, torch.channels_last)]
    cases.append(("edge", None, None, None, None))
    for set_name, specs, dtype, gdtype, layout in cases:
        if specs is None:
            bufs = edge_leaves(dev, gen)
            ps = [p[po:po + n] for (p, po), _, _, n in bufs]
            vs = [v[vo:vo + n] for _, (v, vo), _, n in bufs]
            gs = [g[go:go + n] for _, _, (g, go), n in bufs]
            case = "edge list: mixed dtypes, 4-byte-misaligned views, lengths 1 and 0"
        else:
            def leaf(s, scale, dt):
                t = (torch.randn(s, generator=gen, device=dev) * scale).to(dt)
                return t.contiguous(memory_format=layout) if len(s) == 4 else t

            shapes = [s for s, _ in specs]
            ps = [leaf(s, 0.01, dtype) for s in shapes]
            vs = [leaf(s, 1e-3, torch.float32) for s in shapes]
            gs = [leaf(s, 1e-2, gdtype) for s in shapes]
            case = (f"{set_name} ({len(ps)} leaves) p {str(dtype)[6:]} g {str(gdtype)[6:]} "
                    f"{str(layout)[6:]}")
        norm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs)).item())
        for clip_name, clip in (("off", None), ("under", norm * 10.0), ("over", norm / 3.0)):
            coef = fu.clip_coefficient(gs, clip)
            if clip_name == "over":
                check(abs(coef.item() - 1 / 3.0) < 1e-4, f"clip coefficient {coef.item()}")
            else:
                check(coef.item() == 1.0, f"clip coefficient {coef.item()} with norm under the limit")
            sc = fu.scalars(torch.full((), 0.01, device=dev), coef, dev)
            for variant in ("momentum", "nesterov", "sgd"):
                counter = fu.SGD if variant == "sgd" else fu.MOMENTUM
                want_launches = len(fu.plan(ps, gs, None if variant == "sgd" else vs, capacity=cap))
                if specs is None:  # whole buffers, margins included: nothing outside a view moves
                    kb, pk, vk = edge_copy(bufs)
                    pb, pp, vp = edge_copy(bufs)
                else:
                    kb = pb = None
                    pk, pp = [p.clone() for p in ps], [p.clone() for p in ps]
                    vk, vp = [v.clone() for v in vs], [v.clone() for v in vs]
                counter.reset()
                if variant == "sgd":
                    fu.fused_sgd_leaves(pk, gs, sc, weight_decay=5e-4)
                    fu.fused_sgd_leaves_plain(pp, gs, sc, weight_decay=5e-4)
                else:
                    kw = dict(momentum=0.9, weight_decay=5e-4, nesterov=variant == "nesterov")
                    fu.fused_update_leaves(pk, vk, gs, sc, **kw)
                    fu.fused_update_leaves_plain(pp, vp, gs, sc, **kw)
                check(counter.launches == want_launches,
                      f"{counter.name} counter moved {counter.launches}, the work table asks for "
                      f"{want_launches} ({case})")
                launches_seen[case] = want_launches
                if kb is not None:
                    for (a, va), (b, vb) in zip(kb, pb):
                        if a.dtype == torch.float32:
                            check(torch.equal(a, b), f"{variant} fp32 param buffer differs ({case}, "
                                                     f"clip {clip_name})")
                        check(torch.equal(va, vb), f"{variant} velocity buffer differs ({case}, "
                                                   f"clip {clip_name})")
                err, ulp = 0.0, 0
                for a, b, va, vb in zip(pk, pp, vk, vp):
                    check(torch.equal(va, vb), f"{variant} velocity differs ({case}, clip {clip_name})")
                    if a.numel():
                        err = max(err, (a.float() - b.float()).abs().max().item())
                    if a.dtype == torch.float32:
                        check(torch.equal(a, b), f"{variant} fp32 params not bit-identical ({case}, "
                                                 f"clip {clip_name}): max abs err {err}")
                    elif a.numel():
                        ulp = max(ulp, ulp_distance_bf16(a, b))
                check(ulp <= 1, f"{variant} bf16 params differ by {ulp} ulp ({case}, clip {clip_name})")
                name = "fused_sgd" if variant == "sgd" else "fused_momentum"
                worst[name] = max(worst[name], err)
                worst_ulp = max(worst_ulp, ulp)
                print(f"  {variant:9s} {case:58s} clip {clip_name:5s}: max abs err {err:.3g}, "
                      f"bf16 ulp {ulp}, launches {counter.launches}", flush=True)
                del pk, pp, vk, vp, kb, pb
        del ps, vs, gs
    torch.cuda.synchronize()
    return worst, worst_ulp, launches_seen


def bits_equal(a, b) -> bool:
    """Bit for bit, except that any NaN matches any NaN (its payload is
    the hardware's choice)."""
    import torch

    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a).view(torch.int32),
                                               torch.where(nb, 0.0, b).view(torch.int32))


def special_rows(dev):
    """Rows that are zero, hold a NaN or an inf, have denormal magnitudes,
    sit at the clamp, or hold values on exact half steps of a scale that
    is a power of two (round half to even decides them)."""
    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(9, 128, generator=g, device=dev)
    x[0] = 0.0
    x[1, :] = float("nan")
    x[2, 3] = float("inf")
    x[3, 7] = -float("inf")
    x[4] = torch.randn(128, generator=g, device=dev) * 1e-40
    x[5] = 127.0 * torch.sign(torch.randn(128, generator=g, device=dev))
    k = next(k for k in range(-8, 8)
             if np.float32(127.0 * 2.0 ** k) * np.float32(1 / 127) == np.float32(2.0 ** k))
    halves = (torch.arange(-127, 0, device=dev, dtype=torch.float32) + 0.5) * 2.0 ** k
    x[6, :127], x[6, 127] = halves, 127.0 * 2.0 ** k
    x[7] = -x[6]
    x[8, 1] = float("nan")
    return x


def quant_buffers(shapes, dev):
    """(label, (rows, 128) f32 buffer, length) at the main path's shapes:
    each AlexNet leaf zero-padded to whole rows, with row magnitudes
    spread over e^±9, then lengths 1, 127, 129 and the special rows."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4)
    out = []
    for s in shapes:
        n = math.prod(s)
        rows = -(-n // 128)
        x = torch.randn(rows, 128, generator=g, device=dev) * 1e-2
        x = x * torch.exp(3 * torch.randn(rows, 1, generator=g, device=dev))
        x.view(-1)[n:] = 0.0
        out.append((f"leaf {s}", x, n))
    for n in (1, 127, 129):
        x = torch.zeros(-(-n // 128), 128, device=dev)
        x.view(-1)[:n] = torch.randn(n, generator=g, device=dev)
        out.append((f"length {n}", x, n))
    out.append(("special rows", special_rows(dev), 9 * 128))
    return out


def quant_leaf_lists(shapes, dev):
    """(label, flat f32 leaves, table capacity or None for the library's):
    AlexNet's 16 leaf lengths; lengths 1, 127, 128, 129 and 34,848 (conv1's
    kernel, 272.25 rows) in one list; a leaf with a NaN row, one with an
    inf, one whose 1-element last row is NaN, and the special rows; four
    leaves under a table capacity of 2 (two launches). Row magnitudes
    spread over e^+-9."""
    import torch

    g = torch.Generator(device=dev).manual_seed(8)

    def leaf(n):
        rows = -(-n // 128)
        spread = torch.exp(3 * torch.randn(rows, 1, generator=g, device=dev))
        x = torch.randn(rows, 128, generator=g, device=dev) * 1e-2 * spread
        return x.view(-1)[:n].clone()

    nan_row, inf_leaf, nan_tail = leaf(1000), leaf(300), leaf(129)
    nan_row[256:384] = float("nan")
    inf_leaf[5] = float("inf")
    nan_tail[128] = float("nan")
    return [
        ("AlexNet's 16 leaves", [leaf(math.prod(s)) for s in shapes], None),
        ("lengths 1/127/128/129/34848", [leaf(n) for n in (1, 127, 128, 129, 34_848)], None),
        ("NaN and inf rows", [nan_row, inf_leaf, nan_tail, special_rows(dev).view(-1).clone()],
         None),
        ("table split at capacity 2", [leaf(n) for n in (300, 1, 8193, 129)], 2),
    ]


def guarded(lengths, dev, fill, pad_rows=False):
    """One f32 buffer holding a view per length (each 16-byte aligned, a
    whole row each with ``pad_rows``), 8 guard elements around every
    view, all filled with ``fill`` -> (buffer, views, mask of the guards)."""
    import torch

    sizes = [-(-n // 128) * 128 if pad_rows else n for n in lengths]
    offs, at = [], 8
    for size in sizes:
        offs.append(at)
        at += -(-size // 4) * 4 + 8
    buf = torch.full((at,), fill, device=dev)
    views = [buf[o:o + size] for o, size in zip(offs, sizes)]
    guard = torch.ones(at, dtype=torch.bool, device=dev)
    for o, v in zip(offs, views):
        guard[o:o + v.numel()] = False
    return buf, views, guard


def phase_quant_leaves(shapes, dev):
    """The multi-leaf block codec (#3-4: one launch per table) against its
    plain version, bit for bit: values and scales written between guard
    rows, the dequantize's outputs and padded accumulators between guard
    elements, none of which may move; the wrapper's own buffers; a
    misaligned leaf refused."""
    import torch
    from theanompi_tpu_torch.ops import quant as tq

    cases = quant_leaf_lists(shapes, dev)
    start = {c.name: c.launches for c in (tq.QUANT_BLOCK, tq.DEQUANT_BLOCK)}
    want_q = want_d = 0
    sentinel, g_rows = 1234.5, 2
    for label, xs, cap in cases:
        lengths = [x.numel() for x in xs]
        row0s, rows = tq.leaf_rows(lengths)
        pv, ps, prow0 = tq.quantize_int8_block_leaves_plain(xs)
        launches = -(-len(xs) // (cap or len(xs)))
        # the values 4 bytes off a 16-byte boundary (the kernel moves char4s)
        v0 = g_rows * 128 + 4
        vbuf = torch.full(((rows + 2 * g_rows) * 128,), 0x5A, dtype=torch.int8, device=dev)
        sbuf = torch.full((rows + 2 * g_rows, 1), sentinel, device=dev)
        vals, scales = vbuf[v0:v0 + rows * 128].view(rows, 128), sbuf[g_rows:g_rows + rows]
        got_row0 = tq._quantize_into(xs, vals, scales, capacity=cap)[2]
        check(got_row0 == prow0 == row0s, f"{label}: row0s {got_row0}, plain {prow0}")
        check(bits_equal(vals, pv) and bits_equal(scales, ps),
              f"#3 multi-leaf quantize differs from the plain version ({label})")
        check(bool((vbuf[:v0] == 0x5A).all() and (vbuf[v0 + rows * 128:] == 0x5A).all()
                   and (sbuf[:g_rows] == sentinel).all()
                   and (sbuf[g_rows + rows:] == sentinel).all()),
              f"#3 multi-leaf quantize wrote outside its rows ({label})")
        want_q += launches
        if cap is None:
            wv, ws, _ = tq.quantize_int8_block_leaves(xs)
            check(bits_equal(wv, pv) and bits_equal(ws, ps),
                  f"quantize_int8_block_leaves differs ({label})")
            want_q += 1
        for accumulate in (False, True):
            buf, outs, guard = guarded(lengths, dev, sentinel, pad_rows=accumulate)
            if accumulate:
                for o in outs:
                    o.copy_(torch.randn(o.numel(), device=dev))
            want = tq.dequantize_int8_block_leaves_plain(pv, ps, [o.clone() for o in outs], row0s,
                                                         accumulate)
            tq._dequantize_into(vals, scales, outs, row0s, accumulate, capacity=cap)
            check(all(bits_equal(o, w) for o, w in zip(outs, want)),
                  f"#4 multi-leaf dequantize{' (accumulate)' if accumulate else ''} differs "
                  f"from the plain version ({label})")
            check(bool((buf[guard] == sentinel).all()),
                  f"#4 multi-leaf dequantize wrote outside its outputs ({label})")
            want_d += launches
        print(f"  {label:30s} {len(xs):2d} leaves, {rows:7d} rows, {launches} launch(es) each way: "
              "#3-4 bit-identical, guards untouched", flush=True)
    base = torch.randn(1001, device=dev)
    for what, call in (
        ("x[1]", lambda: tq.quantize_int8_block_leaves([base[:256], base[1:1001]])),
        ("out[0]", lambda: tq.dequantize_int8_block_leaves(
            *tq.quantize_int8_block_leaves([base[:256]])[:2], [base[1:257]], (0,))),
    ):
        try:
            call()
        except ValueError as e:
            check(what in str(e) and "16-byte aligned" in str(e), f"misaligned {what}: {e}")
        else:
            raise Failed(f"a misaligned {what} was not refused")
    want_q += 1  # the quantize that fed the misaligned dequantize
    torch.cuda.synchronize()
    got = {c.name: c.launches - start[c.name] for c in (tq.QUANT_BLOCK, tq.DEQUANT_BLOCK)}
    check(got == {"quant_block": want_q, "dequant_block": want_d},
          f"multi-leaf counters moved {got}, expected {want_q} / {want_d}")
    print("  misaligned x[1] and out[0] refused", flush=True)
    return len(cases)


def quant_whole_buffers(dev):
    """(label, (rows, 128) f32) past the 50 MB L2 for #5: a codec round's
    leaves zero-padded end to end (476,292 rows, 244 MB) and 131,071 rows
    (67 MB, an odd count) of row magnitudes spread over e^+-6, the latter
    also with one NaN, with +inf and -inf, and with -inf alone (the
    scale's sign and NaN cases: NaN and inf scales give zero values)."""
    import torch
    from theanompi_tpu_torch.tools.quant_whole_variants import round_buffer

    g = torch.Generator(device=dev).manual_seed(11)
    rows = 131_071
    x = torch.randn(rows, 128, generator=g, device=dev)
    x *= torch.exp(2 * torch.randn(rows, 1, generator=g, device=dev))
    nan, infs, neg = x.clone(), x.clone(), x.clone()
    nan[77_777, 5] = float("nan")
    infs[65_535, 3], infs[rows - 1, 127] = float("inf"), -float("inf")
    neg[3, 0] = -float("inf")
    return [("a codec round, 244 MB", round_buffer(dev)), ("131071 rows, 67 MB", x),
            ("131071 rows with a NaN", nan), ("131071 rows with +inf and -inf", infs),
            ("131071 rows with -inf", neg)]


def phase_quant_whole(dev) -> int:
    """#5 over buffers past the L2 (``quant_whole_buffers``): the
    one-launch kernel (``quantize_int8``) and the three-pass launcher it
    replaced (``quant._quantize_int8_three_pass``, on no route) each bit
    for bit against ``quantize_int8_plain``; each counter moves by one a
    call."""
    import torch
    from theanompi_tpu_torch.ops import quant as tq

    cases = quant_whole_buffers(dev)
    start = {c.name: c.launches for c in (tq.QUANT, tq.QUANT_THREE_PASS)}
    for label, x in cases:
        pv, ps = tq.quantize_int8_plain(x)
        for name, fn in (("quant", tq.quantize_int8),
                         ("quant_three_pass", tq._quantize_int8_three_pass)):
            v, s = fn(x)
            check(bits_equal(v, pv) and bits_equal(s, ps),
                  f"#5 {name} differs from the plain version ({label}: scale {s.item()!r}, "
                  f"plain {ps.item()!r})")
        print(f"  #5 {label:34s} rows {x.shape[0]:7d}: scale {ps.item()!r}; the one launch and "
              "the three passes bit-identical", flush=True)
    torch.cuda.synchronize()
    got = {c.name: c.launches - start[c.name] for c in (tq.QUANT, tq.QUANT_THREE_PASS)}
    want = {"quant": len(cases), "quant_three_pass": len(cases)}
    check(got == want, f"#5 counters moved {got}, expected {want}")
    return len(cases)


def phase_quant(shapes, dev):
    """Kernels #3-6 and the packed wire against their plain versions."""
    import torch
    from theanompi_tpu_torch.ops import quant as tq
    from theanompi_tpu_torch.ops.kernels import reset_launch_counts

    worst = {"quant_block": 0.0, "dequant_block": 0.0, "quant": 0.0, "dequant": 0.0}
    cases = quant_buffers(shapes, dev)
    g = torch.Generator(device=dev).manual_seed(6)
    reset_launch_counts()
    for label, x, n in cases:
        rows = x.shape[0]
        v, s = tq.quantize_int8_block(x)
        pv, ps = tq.quantize_int8_block_plain(x)
        check(bits_equal(v, pv) and bits_equal(s, ps), f"#3 block quantize differs ({label})")
        d, pd = tq.dequantize_int8_block(v, s), tq.dequantize_int8_block_plain(v, s)
        check(bits_equal(d, pd), f"#4 block dequantize differs ({label})")
        v5, s5 = tq.quantize_int8(x)
        pv5, ps5 = tq.quantize_int8_plain(x)
        check(bits_equal(v5, pv5) and bits_equal(s5, ps5), f"#5 quantize differs ({label})")
        d5, pd5 = tq.dequantize_int8(v5, s5), tq.dequantize_int8_plain(v5, s5)
        check(bits_equal(d5, pd5), f"#6 dequantize differs ({label})")
        # the packed wire: the card's message against the plain version's
        # (built on the CPU), and both decodes; then the ring's decode-and-add
        flat = x.view(-1)[:n]
        pk, pk_plain = tq.wire_encode(flat), tq.wire_encode(flat.cpu())
        check(torch.equal(pk[:rows].cpu(), pk_plain[:rows])
              and bits_equal(tq.wire_scales(pk, rows).cpu(), tq.wire_scales(pk_plain, rows))
              and torch.equal(pk.view(-1)[rows * 132:].cpu(), pk_plain.view(-1)[rows * 132:]),
              f"wire_encode message differs from the plain version's ({label})")
        check(bits_equal(tq.wire_decode(pk, length=n).cpu(), tq.wire_decode(pk_plain, length=n)),
              f"wire_decode differs ({label})")
        acc = torch.randn(rows * 128, generator=g, device=dev)
        want = tq.dequantize_add_int8_block_plain(v, s, acc.view(rows, 128))
        check(bits_equal(tq.wire_decode_add(pk, acc.clone()).view(rows, 128), want),
              f"#4 fused decode-and-add differs ({label})")
        for name, a, b in (("quant_block", d, pd), ("dequant_block", d, pd),
                           ("quant", d5, pd5), ("dequant", d5, pd5)):
            fin = torch.isfinite(a) & torch.isfinite(b)
            worst[name] = max(worst[name], (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0)
        print(f"  {label:30s} rows {rows:7d}: #3-6, wire and decode-and-add bit-identical", flush=True)
    torch.cuda.synchronize()
    k = len(cases)
    want = {"quant_block": 2 * k, "dequant_block": 3 * k, "quant": k, "dequant": k}
    got = {c.name: c.launches for c in (tq.QUANT_BLOCK, tq.DEQUANT_BLOCK, tq.QUANT, tq.DEQUANT)}
    check(got == want, f"quant counters moved {got}, expected {want}")
    return worst, (k + phase_dequant_scales(dev) + phase_quant_leaves(shapes, dev)
                   + phase_quant_whole(dev))


def phase_dequant_scales(dev) -> int:
    """#6 at scales the quantizer does not make: random int8 values with
    +-127 at the floor's scale, 1, -1.5, the largest scale whose products
    stay finite, the largest f32 (products overflow to inf), inf and NaN,
    bit for bit against the plain version; a vals view off a 16-byte
    boundary is refused. Returns the cases run."""
    import torch
    from theanompi_tpu_torch.ops import quant as tq

    g = torch.Generator(device=dev).manual_seed(15)
    vals = torch.randint(-127, 128, (37, 128), generator=g, device=dev, dtype=torch.int8)
    vals[0, :4] = torch.tensor([127, -127, 1, -1], dtype=torch.int8)
    f32 = torch.finfo(torch.float32)
    scales = [1e-30 / 127, 1.0, -1.5, f32.max / 127, f32.max, math.inf, math.nan]
    before = tq.DEQUANT.launches
    for sc in scales:
        scale = torch.tensor([[sc]], dtype=torch.float32, device=dev)
        check(bits_equal(tq.dequantize_int8(vals, scale), tq.dequantize_int8_plain(vals, scale)),
              f"#6 dequantize differs at scale {sc}")
    torch.cuda.synchronize()
    check(tq.DEQUANT.launches - before == len(scales),
          f"#6 launched {tq.DEQUANT.launches - before} times for {len(scales)} scales")
    buf = torch.zeros(37 * 128 + 16, dtype=torch.int8, device=dev)
    try:
        tq.dequantize_int8(buf[4:4 + 37 * 128].view(37, 128), scale)
    except ValueError as e:
        check("16-byte aligned" in str(e), f"misaligned vals refused for another reason: {e}")
    else:
        raise Failed("#6 took a vals view 4 bytes off a 16-byte boundary")
    print(f"  #6 at scales {scales}: bit-identical; a misaligned vals view refused", flush=True)
    return len(scales)


def phase_main():
    """The user's training path through the CLI, counters zeroed just
    before each run and read just after."""
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    runs = {}
    for name, steps, extra in (
        ("fused_momentum", MAIN_STEPS,
         ["--dataset-arg", f"n_train={128 * MAIN_STEPS}", "--dataset-arg", "n_val=128"]),
        ("fused_sgd", SGD_STEPS,
         ["--dataset-arg", f"n_train={128 * SGD_STEPS}", "--dataset-arg", "n_val=128",
          "--recipe-arg", "optimizer=sgd",
          "--recipe-arg", 'opt_kwargs={"weight_decay": 0.0005}',
          "--wire-codec", "int8:ef"]),
    ):
        argv = ["BSP", "1", "alexnet", "AlexNet", "--synthetic", "--fused-update",
                "--max-steps", str(steps), "--print-freq", "1", "--seed", "0",
                *FULL_WIDTH, *extra]
        print(f"[main] python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
        reset_launch_counts()
        summary = run_cli(argv)
        counts = launch_counts()
        launches = counts[name]
        check(summary["steps"] == steps, f"{name} run took {summary['steps']} steps, expected {steps}")
        losses = summary["losses"]
        check(len(losses) == steps and all(math.isfinite(x) for x in losses)
              and summary["nonfinite_steps"] == 0, f"{name} run: non-finite loss in {losses}")
        want = update_launches(16) * steps
        check(launches == want, f"{name} launched {launches} times, expected {want} (one "
                                "multi-tensor launch a step over the 16 fp32 leaves)")
        stray = {k: v for k, v in counts.items() if k != name and v}
        check(not stray, f"the one-card {name} run launched other kernels: {stray} "
                         "(one card runs no codec and no collective)")
        check("val" in summary and all(math.isfinite(v) for v in summary["val"].values()),
              f"{name} run: bad val metrics {summary.get('val')}")
        print(f"[main] {name}: per-step loss {losses}", flush=True)
        print(f"[main] {name}: steady-state step {summary['step_ms']:.3f} ms over "
              f"{summary['steady_steps']} steps (CUDA events, 2 warm-up steps excluded), "
              f"{summary['images_per_sec']:.1f} img/s, launches {counts}", flush=True)
        runs[name] = {"launches": launches, "summary": summary}
    runs["dispatch"] = dispatch_depth_runs()
    return runs


def dispatch_depth_runs() -> dict:
    """AlexNet's CLI step at ``--dispatch-depth 1`` (the reference's
    default: the host waits for each step before it enqueues the next)
    against the port's default (rows read every ``--print-freq`` steps),
    in turns: default, depth 1, depth 3, depth 1, default; on uint8
    ``imagenet_synthetic``, whose feed does not pace the step (float32
    ``--synthetic`` batches do). Every run's JSONL rows must be the same
    but for the wall-clock fields. Depth 3 reaches 3 steps in flight, so
    its rows are read on the side stream while newer steps run (the
    ``partial`` drain); depth 1 never has a newer step in flight."""
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    root = tempfile.mkdtemp(prefix="tmpi-dispatch-")
    out: dict = {"default": [], "depth-1": [], "depth-3": []}
    rows0 = None
    try:
        for i, (label, flags) in enumerate((("default", []), ("depth-1", ["--dispatch-depth", "1"]),
                                            ("depth-3", ["--dispatch-depth", "3"]),
                                            ("depth-1", ["--dispatch-depth", "1"]),
                                            ("default", []))):
            logs = os.path.join(root, str(i))
            argv = ["BSP", "1", "alexnet", "AlexNet", "--dataset", "imagenet_synthetic",
                    "--fused-update", "--max-steps", str(DISPATCH_STEPS), "--seed", "0",
                    "--dataset-arg", f"n_train={128 * DISPATCH_STEPS}", "--dataset-arg",
                    "n_val=128", "--save-dir", logs, *flags]
            print(f"[main] python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
            reset_launch_counts()
            s = run_cli(argv)
            check(launch_counts().get("fused_momentum") == update_launches(16) * DISPATCH_STEPS,
                  f"dispatch {label}: launches {launch_counts()}")
            with open(os.path.join(logs, "alexnet_bsp.jsonl")) as f:
                rows = [{k: v for k, v in json.loads(line).items()
                         if k not in ("images_per_sec", "seconds")} for line in f]
            rows0 = rows0 or rows
            check(rows == rows0, f"dispatch {label}: its JSONL rows differ from the first run's")
            depth = int(flags[1]) if flags else None
            check(s["dispatch_depth"] == depth
                  and (depth is None or s["max_in_flight"] == depth),
                  f"dispatch {label}: depth {s['dispatch_depth']}, {s['max_in_flight']} in flight")
            out[label].append({k: s[k] for k in ("step_ms", "images_per_sec", "host_blocked_s",
                                                 "dispatch_syncs", "max_in_flight",
                                                 "train_loop_s")})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("[main] dispatch depth (CUDA-event step ms, in turns): " + json.dumps(out), flush=True)
    return out


def phase_bsp_ranks(n_cards):
    """Multi-rank BSP through the CLI; every rank's counts come back in
    the summary (each rank is its own process and counts from 0)."""
    import torch

    torch.cuda.empty_cache()
    if n_cards >= 2:
        n = 4 if n_cards >= 4 else 2
        placement = []
        cases = [("psum", "int8:ef"), ("ring_int8", "none")]
    else:
        n, placement = 2, ["--device", "cuda:0", "--backend", "gloo"]
        cases = [("psum", "int8:ef")]
        print("[bsp-ranks] one card: 2 ranks on cuda:0 over gloo; the NCCL runs "
              "(psum + int8:ef and ring_int8 over cards) were not run", flush=True)
    runs = {}
    for strategy, codec in cases:
        argv = ["BSP", str(n), "alexnet", "AlexNet", "--synthetic", "--fused-update",
                "--strategy", strategy, "--wire-codec", codec, "--max-steps", str(RANK_STEPS),
                "--print-freq", "1", "--seed", "0", *FULL_WIDTH, *placement,
                "--dataset-arg", f"n_train={128 * RANK_STEPS}", "--dataset-arg", "n_val=128"]
        print(f"[bsp-ranks] python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
        summary = run_cli(argv)
        label = f"{strategy}+{codec}" if codec != "none" else strategy
        losses = summary["losses"]
        check(summary["steps"] == RANK_STEPS and len(losses) == RANK_STEPS
              and all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
        # under the codec one launch each way a step over all 16 leaves
        per_step = ({"quant_block": 1, "dequant_block": 1} if codec != "none"
                    else {"quant_block": n, "dequant_block": 2 * n - 1})
        per_step["fused_momentum"] = update_launches(16)
        for r, counts in enumerate(summary["kernel_launches_per_rank"]):
            for k, v in per_step.items():
                check(counts[k] == v * RANK_STEPS,
                      f"{label}: rank {r} launched {k} {counts[k]} times, expected "
                      f"{v} x {RANK_STEPS} steps")
        digests = summary["replica_digest_per_rank"]
        check(len(set(digests)) == 1, f"{label}: params/velocities differ across ranks {digests}")
        if codec.endswith(":ef"):
            norms, efd = summary["ef_norm_per_rank"], summary["ef_digest_per_rank"]
            check(all(x > 0 for x in norms) and len(set(efd)) == n,
                  f"{label}: error-feedback residuals not per rank: norms {norms}, digests {efd}")
        print(f"[bsp-ranks] {label} over {n} ranks ({summary['device']}): losses {losses}; "
              f"step_ms per rank {summary['step_ms_per_rank']}; {summary['images_per_sec']:.1f} "
              f"img/s; launches per rank {summary['kernel_launches_per_rank']}; replica digest "
              f"{digests[0]} on every rank", flush=True)
        runs[label] = {"n": n, "summary": summary,
                       "launches": {k: sum(c[k] for c in summary["kernel_launches_per_rank"])
                                    for k in ("quant_block", "dequant_block")}}
    return runs


# phase bsp-exchange: (steps, group) of each run; one card runs fewer steps
EXCHANGE_STEPS = {4: 8, 1: 4}
EXCHANGE_K = 4
EXCHANGE_BUCKET_MB = 25.0
EXCHANGE_PROFILE_STEPS = 5


def exchange_runs(n: int, steps: int, ckpt_root: str) -> list:
    """``[(label, modelfile, modelclass, run_training kwargs)]`` of phase
    bsp-exchange over ``n`` ranks: (a) ResNet-50 with cross-replica BN,
    eager and in captured groups, and without the BN axis; (b) AlexNet
    under hier over 2 slices, with and without int8:ef, and flat psum;
    (c) AlexNet's exchanges, eager and (NCCL ranks only) in captured
    groups."""
    imnet = lambda batch: dict(dataset="imagenet_synthetic",  # noqa: E731
                               dataset_kwargs={"n_train": batch * steps, "n_val": batch})
    common = dict(max_steps=steps, print_freq=0, seed=0, fused_update=True)
    rn_batch = 64 * n
    resnet = dict(common, **imnet(rn_batch), recipe_overrides={"batch_size": rn_batch},
                  strategy="psum", allreduce_buckets=EXCHANGE_BUCKET_MB)
    bn = dict(resnet, recipe_overrides={"batch_size": rn_batch, "bn_axis_name": "data"})
    alex = dict(common, **imnet(128))
    modes = [("eager", 1)] + ([("captured", EXCHANGE_K)] if n >= 4 else [])
    runs = [("a/resnet50-bn-eager", "resnet50", "ResNet50",
             dict(bn, ckpt_dir=os.path.join(ckpt_root, "bn-eager"), async_checkpoint=False))]
    if n >= 4:
        runs.append(("a/resnet50-bn-captured", "resnet50", "ResNet50",
                     dict(bn, steps_per_dispatch=EXCHANGE_K, async_checkpoint=False,
                          ckpt_dir=os.path.join(ckpt_root, "bn-captured"))))
    runs.append(("a/resnet50-per-replica", "resnet50", "ResNet50", resnet))
    for label, kw in (("b/psum", {"ckpt_dir": os.path.join(ckpt_root, "psum")}),
                      ("b/hier", {"strategy": "hier", "ckpt_dir": os.path.join(ckpt_root, "hier")}),
                      ("b/hier+int8:ef", {"strategy": "hier", "wire_codec": "int8:ef"})):
        runs.append((label, "alexnet", "AlexNet",
                     dict(alex, n_slices=2, async_checkpoint=False, **kw)))
    for label, kw in (("psum+int8:ef", {"wire_codec": "int8:ef"}),
                      ("ring_int8", {"strategy": "ring_int8"}),
                      ("buckets", {"allreduce_buckets": EXCHANGE_BUCKET_MB}),
                      ("buckets+int8:ef", {"allreduce_buckets": EXCHANGE_BUCKET_MB,
                                           "wire_codec": "int8:ef"})):
        for mode, k in modes:
            runs.append((f"c/{label}-{mode}", "alexnet", "AlexNet",
                         dict(alex, steps_per_dispatch=k, **kw)))
    return runs


EXCHANGE_PROFILE_TURNS = ("psum", "buckets", "hier", "hier", "buckets", "psum")


def exchange_profile(rank: int, n: int, device) -> dict:
    """(d) Where the step of n NCCL ranks goes: full-width AlexNet (global
    batch 128, float32 batches resident on the card) under flat psum,
    25 MB buckets and hier over 2 slices, in turns (EXCHANGE_PROFILE_TURNS):
    the eager step ms (CUDA events over EXCHANGE_PROFILE_STEPS steps
    after 3 warm-up steps), under ``torch.profiler`` the device ms a step
    of the NCCL kernels (``ncclDevKernel*``: their time includes waiting
    for the peers, so the rank that arrives last reads the exchange's
    own time) and of every other kernel, and the captured step ms (CUDA
    events over a group of EXCHANGE_PROFILE_STEPS replays, after the
    group that captures) -> ``{config: [one dict a turn]}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.tools.profile_step import _device_us

    configs = {"psum": {}, "buckets": {"allreduce_buckets": EXCHANGE_BUCKET_MB},
               "hier": {"strategy": "hier", "n_slices": 2}}
    out = {label: [] for label in configs}
    gen = torch.Generator(device=device).manual_seed(rank)
    x = torch.randn(128 // n, 227, 227, 3, generator=gen, device=device)
    y = torch.randint(0, 1000, (128 // n,), generator=gen, device=device, dtype=torch.int32)
    k = EXCHANGE_PROFILE_STEPS

    def events_ms(fn) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / k

    for label in EXCHANGE_PROFILE_TURNS:
        engine = BSPEngine(AlexNet(), n, device, fused_update=True, **configs[label])
        state = engine.init_state(torch.Generator().manual_seed(0))
        step_gen = torch.Generator(device=device).manual_seed(1)

        def steps():
            nonlocal state
            for _ in range(k):
                state, _ = engine.train_step(state, x, y, step_gen)

        for _ in range(3):
            state, _ = engine.train_step(state, x, y, step_gen)
        torch.cuda.synchronize(device)
        step_ms = events_ms(steps)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps()
            torch.cuda.synchronize(device)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
                   and not e.key.startswith("nccl:")]  # the collectives' own annotations
        nccl = sum(_device_us(e) for e in kernels if e.key.startswith("ncclDevKernel"))
        other = sum(_device_us(e) for e in kernels if not e.key.startswith("ncclDevKernel"))
        state, _ = engine.fused_train_step(state, [x] * k, [y] * k, step_gen)  # captures
        captured_ms = events_ms(lambda: engine.fused_train_step(state, [x] * k, [y] * k,
                                                                step_gen))
        out[label].append({
            "step_ms": step_ms, "captured_step_ms": captured_ms,
            "nccl_kernel_ms_per_step": nccl / 1e3 / k,
            "other_kernel_ms_per_step": other / 1e3 / k,
            "nccl_kernels": sorted({e.key[:60] for e in kernels
                                    if e.key.startswith("ncclDevKernel")}),
            "n_buckets": (len(engine.grad_sync.buckets_for(state.params))
                          if hasattr(engine.grad_sync, "buckets_for") else None)})
        del engine, state
        torch.cuda.empty_cache()
    return out


def exchange_rank(rank, n, device, runs, profile_too):
    """One rank of phase bsp-exchange: every run of ``runs`` through
    ``run_training`` (the CLI's per-rank entry point), the counters zeroed
    just before each and read just after (each summary carries every
    rank's), and a refused captured group for gloo ranks on the card;
    then (NCCL ranks) the profile of (d). Rank 0 returns the summaries."""
    import torch

    from theanompi_tpu_torch.launch.session import resolve_model
    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.ops.kernels import reset_launch_counts

    out = {}
    for label, modelfile, modelclass, kw in runs:
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        out[label] = run_training("bsp", resolve_model(modelfile, modelclass), n,
                                  device=device, **kw)
        out[label]["wall_s"] = time.perf_counter() - t0
        if rank == 0:
            print(f"[bsp-exchange] {label}: {out[label]['wall_s']:.1f} s", flush=True)
    if profile_too:
        out["d"] = exchange_profile(rank, n, device)
    elif torch.device(device).type == "cuda":  # gloo ranks on the card
        try:
            run_training("bsp", resolve_model("alexnet", "AlexNet"), n, device=device,
                         max_steps=2, steps_per_dispatch=2)
            out["gloo_capture_refusal"] = None
        except ValueError as e:
            out["gloo_capture_refusal"] = str(e)
    if profile_too:
        gathered = [None] * n
        torch.distributed.all_gather_object(gathered, out["d"])
        out["d"] = gathered
    return out if rank == 0 else None


def _params_change_rel(path_a: str, path_b: str, p0: dict) -> float:
    """‖(a - p0) - (b - p0)‖ / ‖b - p0‖ over every param entry of two
    checkpoints: how far two runs' parameter changes part."""
    from theanompi_tpu_torch.utils.checkpoint import load_checkpoint

    a, b = load_checkpoint(path_a), load_checkpoint(path_b)
    num = den = 0.0
    for k, v0 in p0.items():
        da = a[k].astype("float64") - v0
        db = b[k].astype("float64") - v0
        num += float(((da - db) ** 2).sum())
        den += float((db ** 2).sum())
    return (num / den) ** 0.5


def _initial_params(modelfile: str, modelclass: str) -> dict:
    """The ``.params/...`` entries a run with seed 0 starts from."""
    import torch

    from theanompi_tpu_torch import bridge
    from theanompi_tpu_torch.launch.session import resolve_model
    from theanompi_tpu_torch.train import init_train_state
    from theanompi_tpu_torch.utils.checkpoint import to_numpy

    model = resolve_model(modelfile, modelclass)()
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    entries = bridge.state_entries(state, model.param_layouts(state.params))
    return {k: to_numpy(v).astype("float64") for k, v in entries.items()
            if k.startswith(".params/")}


def _newest(ckpt_dir: str) -> str:
    files = sorted(os.listdir(ckpt_dir), key=lambda f: int(re.search(r"(\d+)", f).group(1)))
    return os.path.join(ckpt_dir, [f for f in files if f.endswith(".npz")][-1])


def phase_bsp_exchange(n_cards: int) -> dict:
    """The rest of the BSP exchange (module docstring, phase bsp-exchange)."""
    import torch

    from theanompi_tpu_torch.launch.session import spawn_ranks
    from theanompi_tpu_torch.parallel.strategies import assign_buckets
    from theanompi_tpu_torch.tools.update_variants import leaf_specs

    nccl = n_cards >= 4
    n = 4 if nccl else 2
    steps = EXCHANGE_STEPS[4 if nccl else 1]
    if not nccl:
        print("[bsp-exchange] one card: 2 ranks on cuda:0 over gloo, every run eager. Not run "
              "here: NCCL; captured groups of several ranks (gloo refuses them); hier's "
              "in-slice reduce-scatter and all-gather (2 ranks in 2 slices have one rank a "
              "slice); the 4-card split (d)", flush=True)
    root = tempfile.mkdtemp(prefix="tmpi-exchange-")
    try:
        runs = exchange_runs(n, steps, root)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = spawn_ranks(exchange_rank, n, (runs, nccl),
                          device=None if nccl else "cuda:0",
                          backend="nccl" if nccl else "gloo", timeout=900)[0]
        wall = time.perf_counter() - t0
        alex_buckets = len(assign_buckets([torch.empty(s, device="meta")
                                           for s, _ in leaf_specs("alexnet")],
                                          int(EXCHANGE_BUCKET_MB * 2 ** 20)))
        update = {"alexnet": update_launches(16), "resnet50": update_launches(161)}
        codec_per_step = {"a/resnet50-bn-eager": 0, "a/resnet50-bn-captured": 0,
                          "a/resnet50-per-replica": 0, "b/psum": 0, "b/hier": 0,
                          "b/hier+int8:ef": 1}
        for label, modelfile, _, kw in runs:
            s = res[label]
            losses = s["losses"]
            check(s["steps"] == steps and len(losses) == steps and s["nonfinite_steps"] == 0
                  and all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")
            check(len(set(s["replica_digest_per_rank"])) == 1,
                  f"{label}: params/velocities differ across ranks {s['replica_digest_per_rank']}")
            check(len(set(s["model_state_digest_per_rank"])) == 1,
                  f"{label}: BN statistics differ across ranks")
            key = label[2:].rsplit("-", 1)[0]
            if label.startswith("c/"):
                per = ({"quant_block": 1, "dequant_block": 1} if key == "psum+int8:ef" else
                       {"quant_block": n, "dequant_block": 2 * n - 1} if key == "ring_int8" else
                       {"quant_block": alex_buckets, "dequant_block": alex_buckets}
                       if key == "buckets+int8:ef" else {"quant_block": 0, "dequant_block": 0})
            else:
                c = codec_per_step[label]
                per = {"quant_block": c, "dequant_block": c}
            per["fused_momentum"] = update[modelfile]
            for r, counts in enumerate(s["kernel_launches_per_rank"]):
                for k, v in per.items():
                    check(counts[k] == v * steps, f"{label}: rank {r} launched {k} {counts[k]} "
                                                  f"times, expected {v} x {steps} steps")
            if kw.get("wire_codec") == "int8:ef":
                norms, efd = s["ef_norm_per_rank"], s["ef_digest_per_rank"]
                check(all(x > 0 for x in norms) and len(set(efd)) == n,
                      f"{label}: error-feedback residuals not per rank: {norms}, {efd}")
            if kw.get("steps_per_dispatch", 1) > 1:
                check(s["captured"] and s["graph"]["captures"] == 1,
                      f"{label}: not captured once: {s['graph']}")
            print(f"[bsp-exchange] {label} over {n} ranks ({s['device']}): losses {losses}; "
                  f"step_ms per rank {s['step_ms_per_rank']}; {s['images_per_sec']:.1f} img/s; "
                  f"launches per rank {s['kernel_launches_per_rank']}; graph {s['graph']}",
                  flush=True)
        # (a) the BN axis is on: another trajectory than per-replica BN
        bn, per_replica = res["a/resnet50-bn-eager"], res["a/resnet50-per-replica"]
        check(bn["losses"][1:] != per_replica["losses"][1:]
              and bn["model_state_digest_per_rank"] != per_replica["model_state_digest_per_rank"],
              "(a) cross-replica BN ran the per-replica trajectory")
        pairs = []
        if nccl:
            pairs = [(f"c/{k}-eager", f"c/{k}-captured")
                     for k in ("psum+int8:ef", "ring_int8", "buckets", "buckets+int8:ef")]
            pairs.append(("a/resnet50-bn-eager", "a/resnet50-bn-captured"))
            ca, cb = (_newest(os.path.join(root, d)) for d in ("bn-eager", "bn-captured"))
            ea, eb = bn_entries(ca), bn_entries(cb)
            check(sorted(ea) == sorted(eb) and len(ea) == 2 * 53
                  and all(ea[k].tobytes() == eb[k].tobytes() for k in ea),
                  "(a) the captured run's BN statistics are not the eager run's bit for bit")
        for a, b in pairs:
            for key in ("losses", "replica_digest_per_rank", "ef_digest_per_rank",
                        "model_state_digest_per_rank"):
                check(res[a][key] == res[b][key],
                      f"{b} differs from {a} in {key}: {res[a][key]} vs {res[b][key]}")
        # (b) hier against flat psum: the same mean associated otherwise
        hier, flat = res["b/hier"], res["b/psum"]
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(hier["losses"], flat["losses"]))
        change_rel = _params_change_rel(_newest(os.path.join(root, "hier")),
                                        _newest(os.path.join(root, "psum")),
                                        _initial_params("alexnet", "AlexNet"))
        print(f"[bsp-exchange] (b) hier against psum: losses {loss_rel:.3g} apart at most "
              f"(relative), the params' change {change_rel:.3g} in relative norm", flush=True)
        check(loss_rel < 1e-2 and change_rel < 1e-2,
              f"(b) hier against psum: losses {hier['losses']} vs {flat['losses']}, the params' "
              f"change {change_rel} apart in relative norm (limits 1e-2)")
        summary = {"ranks": n, "backend": "nccl" if nccl else "gloo", "steps": steps,
                   "wall_s": wall, "alexnet_buckets": alex_buckets,
                   "hier_vs_psum_loss_rel": loss_rel, "hier_vs_psum_change_rel": change_rel,
                   "runs": {label: {k: res[label][k] for k in (
                       "losses", "step_ms_per_rank", "images_per_sec", "kernel_launches_per_rank",
                       "graph", "wall_s")} for label, *_ in runs}}
        if nccl:
            summary["captured_bit_identical"] = [b for _, b in pairs]
            summary["d"] = res["d"]
            for label in ("psum", "buckets", "hier"):
                for turn in range(len(res["d"][0][label])):
                    ranks = [r[label][turn] for r in res["d"]]
                    nccl = [p["nccl_kernel_ms_per_step"] for p in ranks]
                    print(f"[bsp-exchange] (d) {label}, turn {turn}: eager step ms per rank "
                          f"{[round(p['step_ms'], 3) for p in ranks]}, captured "
                          f"{[round(p['captured_step_ms'], 3) for p in ranks]}; NCCL kernels "
                          f"ms a step per rank {[round(v, 3) for v in nccl]} (the exchange's "
                          f"own: {min(nccl):.3f}, the last rank to arrive); other kernels "
                          f"{[round(p['other_kernel_ms_per_step'], 3) for p in ranks]}",
                          flush=True)
        else:
            check(res["gloo_capture_refusal"] and "cannot be captured" in
                  res["gloo_capture_refusal"],
                  f"gloo ranks grouped steps on the card: {res['gloo_capture_refusal']}")
        print("[bsp-exchange] " + json.dumps(summary), flush=True)
        return summary
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase rules: steps a run with one card (2 gloo ranks) and with 4 cards
RULES_STEPS = {1: 4, 4: 16}
RULES_EPOCH = 8  # steps an epoch of the 4-card runs (a validation pass after each)
RULES_K = 4
# runs of phase rules that also write their checkpoints (the workers'
# rows gathered to rank 0 one at a time: gloo through the host, NCCL by
# point-to-point ops)
RULES_CKPT = ("gosgd/alexnet", "easgd/resnet50-g2-eager")


def rules_runs(n: int, steps: int) -> list:
    """``[(label, modelfile, modelclass, run_training kwargs)]`` of phase
    rules over ``n`` ranks. Two ranks (one card): full-width AlexNet
    under EASGD (``--avg-freq 2 --wire-codec int8:ef``) and GoSGD
    (``--wire-codec int8 --p-push 1``). Four cards: ResNet-50 under EASGD
    (config #4's shape: 4 workers at the recipe's per-worker batch,
    ``--avg-freq 8``) eager and in captured groups of 4, the same in
    workers of 2 cards (cross-replica BN), and VGG16 under GoSGD (config
    #5's shape: 4 workers) with no codec and with int8."""
    common = dict(max_steps=steps, print_freq=0, seed=0, fused_update=True)

    def imnet(model_cls, workers, epoch_steps):
        batch = model_cls.default_recipe().batch_size
        return dict(dataset="imagenet_synthetic",
                    dataset_kwargs={"n_train": workers * batch * epoch_steps,
                                    "n_val": workers * batch})

    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.models.model_zoo.resnet50 import ResNet50
    from theanompi_tpu_torch.models.model_zoo.vgg import VGG16

    if n == 2:
        alex = dict(common, **imnet(AlexNet, 2, steps))
        return [("easgd/alexnet", "alexnet", "AlexNet",
                 dict(alex, rule="easgd", avg_freq=2, wire_codec="int8:ef")),
                ("gosgd/alexnet", "alexnet", "AlexNet",
                 dict(alex, rule="gosgd", wire_codec="int8", p_push=1.0))]
    runs = []
    for g in (1, 2):
        rn = dict(common, **imnet(ResNet50, n // g, RULES_EPOCH), rule="easgd", avg_freq=8,
                  group_size=g)
        for mode, k in (("eager", 1), ("captured", RULES_K)):
            runs.append((f"easgd/resnet50-g{g}-{mode}", "resnet50", "ResNet50",
                         dict(rn, steps_per_dispatch=k)))
    vgg = dict(common, **imnet(VGG16, n, RULES_EPOCH), rule="gosgd", p_push=0.25)
    for codec in ("none", "int8"):
        runs.append((f"gosgd/vgg16-{codec}", "vgg16", "VGG16", dict(vgg, wire_codec=codec)))
    return runs


def rules_rank(rank, n, device, runs):
    """One rank of phase rules: every run through ``run_training`` (the
    CLI's per-rank entry point), the counters zeroed just before each and
    read just after (each summary carries every rank's). Rank 0 returns
    the summaries."""
    import torch

    from theanompi_tpu_torch.launch.session import resolve_model
    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.ops.kernels import reset_launch_counts

    out = {}
    for label, modelfile, modelclass, kw in runs:
        kw = dict(kw)
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        out[label] = run_training(kw.pop("rule"), resolve_model(modelfile, modelclass), n,
                                  device=device, **kw)
        out[label]["wall_s"] = time.perf_counter() - t0
        if rank == 0:
            print(f"[rules] {label}: {out[label]['wall_s']:.1f} s", flush=True)
    return out if rank == 0 else None


def rules_launches(rules: dict, name: str) -> dict:
    """``{run: [launches of kernel name on each rank]}`` of phase rules."""
    return {label: [c[name] for c in run["kernel_launches_per_rank"]]
            for label, run in rules["runs"].items()}


def _check_worker_file(label: str, path: str, s: dict) -> None:
    """A rule's checkpoint holds every worker's row, the workers as the
    run's digests say (distinct rows), each at the run's step."""
    import numpy as np

    f = np.load(path)
    stacks = [k for k in f.files if k.startswith(".workers/")]
    n_workers = s["n_workers"]
    check(stacks and all(f[k].shape[0] == n_workers for k in stacks),
          f"{label}: {path} stacks {sorted({f[k].shape[0] for k in stacks})} workers, "
          f"expected {n_workers}")
    check(all(int(v) == s["steps"] for v in f[".workers/.step"]),
          f"{label}: the file's worker steps {f['.workers/.step']}, expected {s['steps']}")
    check(any(not np.array_equal(f[k][0], f[k][1]) for k in stacks
              if k.startswith(".workers/.params/")),
          f"{label}: the file's workers are all equal")
    print(f"[rules] {label}: {path} holds {n_workers} workers' rows "
          f"({os.path.getsize(path) / 2 ** 20:.1f} MiB)", flush=True)


def phase_rules(n_cards: int, smi: str) -> dict:
    """EASGD and GoSGD on the card (module docstring, phase rules)."""
    import torch

    from theanompi_tpu_torch.launch.session import spawn_ranks

    nccl = n_cards >= 4
    n = 4 if nccl else 2
    steps = RULES_STEPS[4 if nccl else 1]
    if not nccl:
        print("[rules] one card: 2 ranks on cuda:0 over gloo, eager (gloo refuses captured "
              "groups of several ranks); the exchange and the gossip hop go through the "
              "host. Not run here: NCCL, ResNet-50 and VGG16 on 4 workers, worker groups",
              flush=True)
    root = tempfile.mkdtemp(prefix="tmpi-rules-")
    try:
        runs = [(label, mf, mc, dict(kw, ckpt_dir=os.path.join(root, label.replace("/", "_")))
                 if label in RULES_CKPT else kw) for label, mf, mc, kw in rules_runs(n, steps)]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = spawn_ranks(rules_rank, n, (runs,), device=None if nccl else "cuda:0",
                          backend="nccl" if nccl else "gloo", timeout=900)[0]
        wall = time.perf_counter() - t0
        for label, _, _, kw in runs:
            if "ckpt_dir" in kw:
                _check_worker_file(label, _newest(kw["ckpt_dir"]), res[label])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    update = {"alexnet": update_launches(16), "resnet50": update_launches(161),
              "vgg16": update_launches(32)}
    for label, modelfile, _, kw in runs:
        s = res[label]
        losses = s["losses"]
        check(s["steps"] == steps and len(losses) == steps and s["nonfinite_steps"] == 0
              and all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")
        g = kw.get("group_size", 1)
        workers = n // g
        check(s["n_workers"] == workers and s["global_batch"] == workers * s["per_worker_batch"],
              f"{label}: {s['n_workers']} workers, global batch {s['global_batch']}")
        rounds = steps // kw["avg_freq"] if kw["rule"] == "easgd" else steps
        check(all(c == rounds for c in s["comm_rounds_per_rank"]),
              f"{label}: exchanges per rank {s['comm_rounds_per_rank']}, expected {rounds}")
        codec = kw.get("wire_codec", "none")
        per_round = ({"quant_block": 1, "dequant_block": 1} if codec.startswith("int8")
                     else {"quant_block": 0, "dequant_block": 0})
        want = {k: v * rounds for k, v in per_round.items()}
        want["fused_momentum"] = update[modelfile] * steps
        for r, counts in enumerate(s["kernel_launches_per_rank"]):
            for k, v in want.items():
                check(counts[k] == v, f"{label}: rank {r} launched {k} {counts[k]} times, "
                                      f"expected {v}")
        digests = s["worker_digest_per_rank"]
        check(len(set(digests)) == workers and all(
            digests[i] == digests[i - i % g] for i in range(n)),
            f"{label}: worker digests {digests} (workers must differ, a group agree)")
        if kw["rule"] == "easgd":
            check(len(set(s["center_digest_per_rank"])) == 1,
                  f"{label}: the center differs across ranks {s['center_digest_per_rank']}")
        else:
            share = sum(s["alpha_per_rank"][::g])
            check(abs(share - 1.0) < 1e-6, f"{label}: shares {s['alpha_per_rank']} sum to {share}")
        if codec.endswith(":ef"):
            check(all(v > 0 for v in s["ef_norm_per_rank"]),
                  f"{label}: error-feedback residuals {s['ef_norm_per_rank']}")
        if kw.get("steps_per_dispatch", 1) > 1:
            check(s["captured"] and s["graph"]["captures"] == 1,
                  f"{label}: not captured once: {s['graph']}")
        print(f"[rules] {label} over {n} ranks ({s['device']}, {smi}): losses {losses}; "
              f"local step ms per rank {s['local_step_ms_per_rank']}; "
              f"{'exchange' if kw['rule'] == 'easgd' else 'gossip round'} ms per rank "
              f"{s['comm_ms_per_rank']} (median; the slowest {s['comm_ms_max_per_rank']}); "
              f"step ms per rank {s['step_ms_per_rank']}; "
              f"{s['images_per_sec']:.1f} img/s; launches per rank "
              f"{s['kernel_launches_per_rank']}; graph {s['graph']}", flush=True)
    # the 4-card runs' eager and captured ResNet-50 pairs (rules_runs)
    pairs = [(f"easgd/resnet50-g{g}-eager", f"easgd/resnet50-g{g}-captured")
             for g in (1, 2)] if nccl else []
    for a, b in pairs:
        for key in ("losses", "worker_digest_per_rank", "center_digest_per_rank",
                    "model_state_digest_per_rank", "val"):
            check(res[a][key] == res[b][key],
                  f"{b} differs from {a} in {key}: {res[a][key]} vs {res[b][key]}")
    summary = {"ranks": n, "backend": "nccl" if nccl else "gloo", "steps": steps,
               "wall_s": wall, "card": smi, "captured_bit_identical": [b for _, b in pairs],
               "runs": {label: {k: res[label][k] for k in (
                   "losses", "local_step_ms_per_rank", "comm_ms_per_rank",
                   "comm_ms_max_per_rank", "step_ms_per_rank",
                   "images_per_sec", "kernel_launches_per_rank", "comm_rounds_per_rank",
                   "graph", "wall_s")} for label, *_ in runs}}
    print("[rules] " + json.dumps(summary), flush=True)
    return summary


def _keep_newest(ckpt_dir: str) -> None:
    """Remove every checkpoint in ``ckpt_dir`` but the newest (disk): a
    single file, or every member of the newest sharded set."""
    from theanompi_tpu_torch.utils.checkpoint import checkpoint_step, latest_checkpoint

    newest = latest_checkpoint(ckpt_dir)
    if newest is None:
        return
    keep = checkpoint_step(newest)
    for f in os.listdir(ckpt_dir):
        m = re.search(r"ckpt_(\d+)\.", f)
        if m and f.endswith(".npz") and int(m.group(1)) != keep:
            os.unlink(os.path.join(ckpt_dir, f))


def _state_digest(path: str) -> str:
    """The digest a gathered save of the state in ``path`` records (a
    single file, or a sharded set reassembled)."""
    from theanompi_tpu_torch.utils.checkpoint import (
        integrity_manifest, load_checkpoint, manifest_digest)

    return manifest_digest(integrity_manifest(load_checkpoint(path)))


def compare_final(control: str, resumed: dict) -> dict:
    """Entry by entry, each resumed run's final checkpoint (a sharded set
    reassembled) must equal the uninterrupted control's bit for bit:
    dtype, shape and bytes."""
    from theanompi_tpu_torch.utils.checkpoint import load_checkpoint

    fc = load_checkpoint(control)
    keys = sorted(fc)
    for label, path in resumed.items():
        fr = load_checkpoint(path)
        check(sorted(fr) == keys, f"{label}: its final checkpoint holds other entries "
                                  f"({sorted(set(fr) ^ set(keys))})")
        differ = [k for k in keys if fr[k].dtype != fc[k].dtype or fr[k].shape != fc[k].shape
                  or fr[k].tobytes() != fc[k].tobytes()]
        check(not differ, f"{label}: {len(differ)} entries differ from the uninterrupted "
                          f"run's, first {differ[:4]}")
    return {"entries": len(keys), "bit_identical": sorted(resumed)}


def _records(obs_dir: str) -> list:
    with open(os.path.join(obs_dir, "supervisor.jsonl")) as f:
        return [json.loads(line) for line in f]


def _check_launches(label: str, counts: dict, steps: int, codec: bool) -> None:
    """One rank's counts of ``steps`` steps: one fused_momentum launch a
    step over the 16 leaves, and with the codec one quant_block and one
    dequant_block a step (none without)."""
    want = {"fused_momentum": update_launches(16) * steps,
            "quant_block": steps if codec else 0, "dequant_block": steps if codec else 0}
    got = {k: counts.get(k, 0) for k in want}
    check(got == want, f"{label}: launches {got}, expected {want}")


def _resume_checks(label: str, s: dict, path: str, step: int) -> None:
    """The resumed run loaded the state of ``path`` (the digest a save of
    it records) at ``step``, with its dropout generators."""
    check(s["resumed_from_step"] == step,
          f"{label}: resumed from {s['resumed_from_step']}, expected {step}")
    want = _state_digest(path)
    check(s["resume"]["digest"] == want, f"{label}: the loaded state's digest "
                                         f"{s['resume']['digest']} is not the file's {want}")
    check(s["resume"]["torch_rng_restored"], f"{label}: the dropout generators were not restored")


def _reshard_checks(label: str, s: dict, set_path: str, from_world: int, to_world: int,
                    step: int) -> None:
    """An elastic retry resharded the set ``set_path`` (step ``step``, a
    world of ``from_world``) onto ``to_world`` ranks: the params it
    loaded are the set's bit for bit, the residuals were reset, and the
    dropout streams restarted from (seed, rank)."""
    from theanompi_tpu_torch.utils.checkpoint import (
        integrity_manifest, load_checkpoint, manifest_digest)

    check(s["world"] == to_world and s["devices"] == to_world
          and s["resharded_from_world"] == from_world and s["resumed_from_step"] == step,
          f"{label}: world {s['world']}, resharded from {s['resharded_from_world']} at step "
          f"{s['resumed_from_step']}, expected {from_world} -> {to_world} at {step}")
    r = s["reshard"]
    saved = load_checkpoint(set_path)
    params = {k: v for k, v in saved.items() if k.startswith(".params/")}
    check(r["params_digest"] == manifest_digest(integrity_manifest(params)),
          f"{label}: the loaded params are not the set's")
    check(len(r["reset"]) == 16 and all(k.startswith(".ef/") for k in r["reset"]),
          f"{label}: reset leaves {r['reset']}, expected the 16 .ef residuals")
    check(not s["resume"]["torch_rng_restored"],
          f"{label}: generator rows of {from_world} ranks restored onto {to_world}")


def phase_resume(n_cards: int = 1, nccl_only: bool = False, sharded_crash: bool = True):
    """Checkpoint, resume and the supervisor through the CLI (module
    docstring, phase resume): one card, 2 ranks sharing it over gloo,
    and with 4 cards an NCCL shrink from 4 ranks to 2 (alone with
    ``nccl_only``). ``sharded_crash``: the 2 ranks' crash into a sharded
    set resumed on the same world (``--only resume``; the default run
    leaves it to the elastic shrink, whose attempt 1 writes the same
    kind of set)."""
    import torch

    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from theanompi_tpu_torch.utils.checkpoint import latest_checkpoint, read_resumable_marker

    results = {}
    configs = [
        ("one-card", 1, []),
        ("2-ranks-psum-int8:ef", 2, ["--device", "cuda:0", "--backend", "gloo",
                                     "--strategy", "psum", "--wire-codec", "int8:ef"]),
    ]
    if n_cards >= 4:
        nccl = ("4-ranks-nccl-psum-int8:ef", 4, ["--strategy", "psum", "--wire-codec", "int8:ef"])
        configs = [nccl] if nccl_only else configs + [nccl]
    for label, n, extra in configs:
        torch.cuda.empty_cache()
        root = tempfile.mkdtemp(prefix="tmpi-resume-")
        try:
            def run(name, *flags, rc=0):
                d = os.path.join(root, name)
                argv = ["BSP", str(n), "alexnet", "AlexNet", "--synthetic", "--fused-update",
                        "--max-steps", str(RESUME_STEPS), "--seed", "0", *FULL_WIDTH,
                        "--dataset-arg", f"n_train={128 * RESUME_EPOCH}",
                        "--dataset-arg", "n_val=128", "--ckpt-dir", d, *extra, *flags]
                print(f"[resume] python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
                reset_launch_counts()
                t0 = time.perf_counter()
                summary = run_cli(argv, rc)
                wall = time.perf_counter() - t0
                if rc:
                    return summary, None, d
                summary["wall_s"] = wall
                counts = (summary["kernel_launches_per_rank"] if summary["devices"] > 1
                          else [launch_counts()])
                check(summary["steps"] == RESUME_STEPS and summary["nonfinite_steps"] == 0
                      and all(math.isfinite(v) for v in summary["losses"]),
                      f"{label} {name}: steps {summary['steps']}, losses {summary['losses']}")
                return summary, counts, d

            codec = n > 1
            info = {"ranks": n, "launches": {}}
            final = {}

            def note_launches(name, s, counts):
                """Each attempt's counts of the path's kernels, rank by rank
                (the kernels line)."""
                attempts = [f["launches_per_rank"] for f in s["failed_attempts"]] + [counts]
                info["launches"][name] = [
                    [{k: c.get(k, 0) for k in ("fused_momentum", "quant_block", "dequant_block")}
                     for c in ranks] for ranks in attempts]

            sync_saves = []  # the --sync-ckpt runs' saves
            if n < 4:
                # the uninterrupted run (the async writer); the resumed runs
                # write async and --sync-ckpt, and each must end at its state
                ctrl, _, dc = run("control")
                _keep_newest(dc)
            if n == 1:
                # a supervised crash: ckpt_4 rots at rest, the crash before
                # step 5 leaves no newer save, so the retry scrubs ckpt_4 away
                # and walks back to ckpt_2
                obs = os.path.join(root, "obs-crash")
                s, counts, d = run("supervised-crash", "--max-retries", "2", "--retry-backoff",
                                   "0", "--inject-fault", "bitrot@4", "--inject-fault",
                                   "crash@5", "--obs-dir", obs)
                check(s["retries"] == 1 and s["retry_causes"] == {"crash": 1},
                      f"{label} supervised crash: retries {s['retries']} {s['retry_causes']}")
                check(os.listdir(os.path.join(d, "quarantine")) == ["ckpt_4.npz"],
                      f"{label} supervised crash: quarantine holds "
                      f"{os.listdir(os.path.join(d, 'quarantine'))}")
                (retry,) = [r for r in _records(obs) if r["kind"] == "retry"]
                check(retry["step"] == 2, f"{label} supervised crash: the retry record names "
                                          f"step {retry['step']}, expected 2")
                _resume_checks(f"{label} supervised crash", s, os.path.join(d, "ckpt_2.npz"), 2)
                (failed,) = s["failed_attempts"]
                _check_launches(f"{label} supervised crash, attempt 1",
                                failed["launches_per_rank"][0], 4, False)
                # one process: the counts hold both attempts (4 + 4 steps)
                _check_launches(f"{label} supervised crash, both attempts", counts[0], 8, False)
                final["supervised-crash"] = latest_checkpoint(d)
                note_launches("supervised-crash", s, counts)
                info["supervised_crash"] = {"recovery_ms": s["recovery_ms"],
                                            "recovery": s["recovery"], "retry": retry,
                                            "load_ms": s["resume"]["load_ms"],
                                            "verify_ms": s["resume"]["verify_ms"],
                                            "wall_s": s["wall_s"]}
                # preemption: SIGTERM before step 3 (the grace path saves step 3
                # and marks the run), then the same command resumes by itself
                pflags = ["--max-retries", "1", "--sigterm-grace", "30", "--sync-ckpt",
                          "--inject-fault", "sigterm@3", "--fault-ledger",
                          os.path.join(root, "ledger")]
                out, _, d = run("preempted", *pflags, rc=75)
                check(out == {"preempted": True, "step": 3, "resumable": True},
                      f"{label} preemption: the CLI printed {out}")
                marker = read_resumable_marker(d)
                check(marker is not None and marker["step"] == 3,
                      f"{label} preemption: marker {marker}")
                s2, counts2, d = run("preempted", *pflags)
                check(s2["preempt_resumes"] == 1 and s2["retries"] == 0
                      and read_resumable_marker(d) is None,
                      f"{label} preemption: {s2['preempt_resumes']} marker resumes, "
                      f"{s2['retries']} retries")
                _resume_checks(f"{label} preemption", s2, os.path.join(d, "ckpt_3.npz"), 3)
                _check_launches(f"{label} preemption, the resumed invocation", counts2[0], 3, False)
                sync_saves += s2["checkpoints"]
                final["preempted"] = latest_checkpoint(d)
                note_launches("preempted", s2, counts2)
                info["preempted"] = {"load_ms": s2["resume"]["load_ms"], "wall_s": s2["wall_s"]}
            elif n == 2:
                # the default multi-rank resume, from a gathered file: no rank
                # makes a crash save (a gathered save is collective), so the
                # retry resumes from ckpt_4, written with --sync-ckpt
                obs = os.path.join(root, "obs-gathered")
                s, counts, d = run("gathered-crash", "--sync-ckpt", "--max-retries", "1",
                                   "--retry-backoff", "0", "--inject-fault", "crash@5",
                                   "--obs-dir", obs)
                check(s["retries"] == 1 and s["retry_causes"] == {"crash": 1},
                      f"{label} gathered crash: retries {s['retries']} {s['retry_causes']}")
                (retry,) = [r for r in _records(obs) if r["kind"] == "retry"]
                check(retry["step"] == 4, f"{label} gathered crash: the retry record names "
                                          f"step {retry['step']}, expected 4")
                _resume_checks(f"{label} gathered crash", s, os.path.join(d, "ckpt_4.npz"), 4)
                (failed,) = s["failed_attempts"]
                check(len(failed["launches_per_rank"]) == 2,
                      f"{label} gathered crash: attempt 1 reported "
                      f"{len(failed['launches_per_rank'])} ranks' launches")
                for rank in range(2):
                    _check_launches(f"{label} gathered crash, attempt 1 rank {rank}",
                                    failed["launches_per_rank"][rank], 4, codec)
                    _check_launches(f"{label} gathered crash, attempt 2 rank {rank}",
                                    counts[rank], 2, codec)
                check(s["ef_digest_per_rank"][0] != s["ef_digest_per_rank"][1]
                      and len(set(s["replica_digest_per_rank"])) == 1,
                      f"{label} gathered crash: residuals or replicas after the resume")
                sync_saves += s["checkpoints"]
                final["gathered-crash"] = latest_checkpoint(d)
                note_launches("gathered-crash", s, counts)
                info["gathered_crash"] = {"recovery_ms": s["recovery_ms"],
                                          "recovery": s["recovery"], "retry": retry,
                                          "load_ms": s["resume"]["load_ms"],
                                          "verify_ms": s["resume"]["verify_ms"],
                                          "wall_s": s["wall_s"]}
            if n == 2 and sharded_crash:
                # each rank's crash save completes one sharded set at step 3
                s, counts, d = run("sharded-crash", "--ckpt-sharded", "--max-retries", "1",
                                   "--retry-backoff", "0", "--inject-fault", "crash@4")
                members = sorted(f for f in os.listdir(d) if f.startswith("ckpt_3."))
                check(members == ["ckpt_3.proc0of2.npz", "ckpt_3.proc1of2.npz"],
                      f"{label} sharded crash: step 3's set is {members}")
                _resume_checks(f"{label} sharded crash", s,
                               os.path.join(d, "ckpt_3.proc0of2.npz"), 3)
                (failed,) = s["failed_attempts"]
                for rank in range(2):
                    _check_launches(f"{label} sharded crash, attempt 1 rank {rank}",
                                    failed["launches_per_rank"][rank], 3, codec)
                    _check_launches(f"{label} sharded crash, attempt 2 rank {rank}",
                                    counts[rank], 3, codec)
                check(s["ef_digest_per_rank"][0] != s["ef_digest_per_rank"][1]
                      and len(set(s["replica_digest_per_rank"])) == 1,
                      f"{label} sharded crash: residuals or replicas after the resume")
                final["sharded-crash"] = latest_checkpoint(d)
                note_launches("sharded-crash", s, counts)
                sharded_saves = [c for c in s["checkpoints"] if c["mode"] == "async"]
                info["sharded_crash"] = {"recovery_ms": s["recovery_ms"],
                                         "recovery": s["recovery"],
                                         "load_ms": s["resume"]["load_ms"],
                                         "async_save_ms": [{k: c[k] for k in (
                                             "step", "loop_ms", "writer_ms", "write_ms", "bytes")}
                                             for c in sharded_saves],
                                         "wall_s": s["wall_s"]}
            if n > 1:
                # an elastic shrink: the world drops to n/2 ranks before step 4;
                # the crash saves complete step 3's set, and the retry reshards it
                to = n // 2
                s, counts, d = run("elastic-shrink", "--ckpt-sharded", "--elastic",
                                   "--max-retries", "1", "--retry-backoff", "0",
                                   "--inject-fault", f"shrink@4:{to}")
                _reshard_checks(f"{label} elastic shrink", s,
                                os.path.join(d, f"ckpt_3.proc0of{n}.npz"), n, to, 3)
                (failed,) = s["failed_attempts"]
                for rank in range(n):
                    _check_launches(f"{label} elastic shrink, attempt 1 rank {rank}",
                                    failed["launches_per_rank"][rank], 3, True)
                for rank in range(to):
                    _check_launches(f"{label} elastic shrink, attempt 2 rank {rank}",
                                    counts[rank], 3, to > 1)
                note_launches("elastic-shrink", s, counts)
                info["elastic_shrink"] = {"reshard": s["reshard"], "recovery_ms": s["recovery_ms"],
                                          "recovery": s["recovery"],
                                          "wall_s": s["wall_s"], "world": s["world"]}
            if n < 4:
                cmp = compare_final(ctrl["checkpoints"][-1]["path"], final)
                info.update({
                    "compare": cmp,
                    "file_bytes": ctrl["checkpoints"][-1]["bytes"],
                    "sync_save_ms": [{k: c[k] for k in ("step", "gather_ms", "crc_ms", "write_ms",
                                                         "loop_ms")} for c in sync_saves],
                    "async_save_ms": [{k: c[k] for k in ("step", "loop_ms", "writer_ms", "crc_ms",
                                                          "write_ms")}
                                      for c in ctrl["checkpoints"]],
                    "epoch_step_ms": ctrl["epoch_step_ms"],
                    "losses": {"control": ctrl["losses"]},
                })
                print(f"[resume] {label}: {', '.join(cmp['bit_identical'])} end bit for bit at the "
                      f"uninterrupted run's state ({cmp['entries']} entries)", flush=True)
                print(f"[resume] {label}: file {info['file_bytes']} bytes; sync save "
                      f"{info['sync_save_ms']}; async save {info['async_save_ms']}; epoch step "
                      f"ms {info['epoch_step_ms']}", flush=True)
            print(f"[resume] {label}: " + json.dumps(
                {k: v for k, v in info.items() if k not in ("compare", "losses")}), flush=True)
            results[label] = info
        finally:
            shutil.rmtree(root, ignore_errors=True)
    print("[resume] " + json.dumps(results), flush=True)
    return results


def phase_parity(dev):
    """Small AlexNet: 2 steps on the card vs 2 steps on the CPU."""
    import torch
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.train import init_train_state, make_train_step
    from theanompi_tpu_torch.tree import tree_leaves

    recipe = AlexNet.default_recipe().replace(
        input_shape=(67, 67, 3), num_classes=10, batch_size=8, compute_dtype=torch.float32,
        sched_kwargs={"lr": 0.001, "boundaries": [30, 50, 65], "factor": 0.1})
    model = AlexNet(recipe)
    for layer in model.net.layers:
        if hasattr(layer, "rate"):
            layer.rate = 0.0
    rng = torch.Generator().manual_seed(3)
    xs = [torch.randn(8, 67, 67, 3, generator=rng) for _ in range(2)]
    ys = [torch.randint(0, 10, (8,), generator=rng) for _ in range(2)]
    out = {}
    for d in ("cpu", dev):
        state = init_train_state(model, torch.Generator().manual_seed(7), d)
        before = [p.detach().cpu().clone() for p in tree_leaves(state.params)]
        step = make_train_step(model, fused_update=True)
        losses = []
        for x, y in zip(xs, ys):
            state, m = step(state, x.to(d), y.to(d), None)
            losses.append(float(m["loss"]))
        after = [p.detach().cpu() for p in tree_leaves(state.params)]
        vels = [v.detach().cpu() for v in tree_leaves(state.opt_state["vel"])]
        out[str(d)] = (losses, [a - b for a, b in zip(after, before)], vels, after)
    (lc, dc, vc, pc), (lg, dg, vg, _) = out["cpu"], out[str(dev)]
    check(all(math.isclose(a, b, rel_tol=1e-3) for a, b in zip(lc, lg)),
          f"card losses {lg} vs CPU {lc}")
    worst = {"parameter change": 0.0, "velocity": 0.0}
    for what, cpu, card in (("parameter change", dc, dg), ("velocity", vc, vg)):
        for i, (a, b) in enumerate(zip(cpu, card)):
            scale = a.abs().max().item()
            check(scale > 0 and b.abs().max().item() > 0, f"leaf {i}: no {what} on the card or CPU")
            slack = 1e-3 * a.abs()
            if what == "parameter change":
                p = pc[i].abs()
                slack = slack + 2 * (torch.nextafter(p, torch.full_like(p, math.inf)) - p)
            err = ((a - b).abs() - slack).max().item() / scale
            worst[what] = max(worst[what], err)
            check(err <= 2e-3, f"leaf {i}: card {what} differs from CPU by {err:.3g} of its "
                               "largest value beyond the slack (limit 2e-3)")
    print(f"[parity] losses card {lg} vs CPU {lc}; worst excess over the slack, as a share of "
          f"each leaf's largest value (limit 2e-3): {worst}", flush=True)


def host_us(fn, reps: int = 20) -> float:
    """Host wall-clock microseconds per call of ``fn`` (the enqueue: no
    synchronise inside the timed loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e6


def phase_times(leaf_sets, dev, mem_rate, fp32_peak):
    """#1 and #2 per optimizer step over each model's leaves (fp32, the
    models' layouts), in turns (A B C D, twice): the multi-tensor
    kernel through its wrapper, the same launch with its table built once
    (the device's time alone), the per-leaf launches it replaced
    (tools/update_variants.py) and ATen's fused SGD; the bound; the plain
    version; the host's microseconds per ``Optimizer.apply`` call, the
    fused one and the replaced one in turns."""
    import torch
    from theanompi_tpu_torch.ops import fused_update as fu
    from theanompi_tpu_torch.tools import update_variants as uv

    cap = fu._LIB.get().tmpi_fused_table_capacity()
    lr = torch.full((), 0.01, device=dev)
    results = {}
    for set_name, specs in leaf_sets:
        ps, vs, gs = uv.make_leaves(specs, dev)
        sc = fu.scalars(lr, fu.clip_coefficient(gs, None), dev)
        n_total = sum(p.numel() for p in ps)
        for name, rule in (("fused_momentum", "momentum"), ("fused_sgd", "sgd")):
            kw = uv.RULES[rule]
            ways = uv.step_fns(rule, ps, vs, gs, sc)
            if rule == "sgd":
                bpe, ope, state, lib_kw = 12, 5, (), dict(momentum=0.0, weight_decay=5e-4)
            else:
                bpe, ope, state, lib_kw = 20, 7, {"vel": vs}, dict(momentum=0.9, weight_decay=5e-4)
            launches = len(fu.plan(ps, gs, None if rule == "sgd" else vs, capacity=cap))
            # the same launches, checked and tabled once: the device's time alone
            device_only = uv.prepare(fu._LIB.get().tmpi_fused_update_multi, rule, ps, gs, sc,
                                     None if rule == "sgd" else vs, **kw)
            byts = n_total * bpe + 8 * launches  # + the 2-float scalar block per launch
            ops = n_total * ope
            bytes_ms, ops_ms = byts / mem_rate * 1e3, ops / fp32_peak * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            leaves = [torch.nn.Parameter(p.clone()) for p in ps]
            for leaf, g in zip(leaves, gs):
                leaf.grad = g.clone()
            library = torch.optim.SGD(leaves, lr=0.01, fused=True, **lib_kw)
            optimizer = fu.fuse_optimizer(rule, **kw)
            turns = {"kernel": [], "kernel_table_built": [], "per_leaf": [], "library": []}
            host = {"kernel": [], "per_leaf": []}
            with torch.no_grad():
                for _ in range(2):
                    turns["kernel"].append(cuda_ms(ways["multi"], reps=20))
                    turns["kernel_table_built"].append(cuda_ms(device_only, reps=20))
                    turns["per_leaf"].append(cuda_ms(ways["per_leaf"], reps=20))
                    turns["library"].append(cuda_ms(library.step, reps=20))
                plain_ms = cuda_ms(ways["plain"], reps=5)
            for _ in range(2):
                host["kernel"].append(host_us(lambda: optimizer.apply(gs, state, ps, lr)))
                host["per_leaf"].append(host_us(lambda: uv.per_leaf_apply(rule, ps, vs, gs, lr)))
            del library, leaves
            mean = {k: sum(v) / len(v) for k, v in turns.items()}
            host_mean = {k: sum(v) / len(v) for k, v in host.items()}
            results[(name, set_name)] = dict(
                step_ms=mean["kernel"], per_leaf_ms=mean["per_leaf"], library_ms=mean["library"],
                table_built_ms=mean["kernel_table_built"],
                turns_ms=turns, plain_ms=plain_ms, bound_ms=bound_ms, bytes=byts, ops=ops,
                launches=launches, host_us_per_apply=host_mean, host_us_turns=host,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            print(f"[times] {name} over {set_name}'s {len(ps)} leaves ({n_total} params): "
                  f"{mean['kernel']:.4f} ms/step ({launches} launch) | bound {bound_ms:.4f} ms "
                  f"({byts / 1e9:.4f} GB at {mem_rate / 1e12:.2f} TB/s; "
                  f"{results[(name, set_name)]['bound_by']}) | {bound_ms / mean['kernel'] * 100:.1f}% "
                  f"of bound | table built once (device alone) {mean['kernel_table_built']:.4f} ms "
                  f"({bound_ms / mean['kernel_table_built'] * 100:.1f}%) | per-leaf launches "
                  f"{mean['per_leaf']:.4f} ms | "
                  f"torch.optim.SGD(fused=True, {lib_kw}) {mean['library']:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | turns x 2: {turns}", flush=True)
            print(f"[times] {name} over {set_name}: host us per Optimizer.apply (no sync) "
                  f"{host_mean['kernel']:.1f} (one launch) vs {host_mean['per_leaf']:.1f} "
                  f"({len(ps)} launches), {host_mean['per_leaf'] / host_mean['kernel']:.2f}x; "
                  f"turns {host}", flush=True)
        del ps, vs, gs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return results


def phase_quant_times(dev, mem_rate, fp32_peak):
    """#3-4 per codec round over AlexNet's 16 leaves (flat f32, one launch
    each way), in turns (A B C [D E], twice): the wrapper, host work
    included; the same launch with its table built once (the device's
    time alone); the codec's former call pattern, one call of the
    one-buffer wrapper per leaf's padded (rows, 128) buffer (16 one-leaf
    launches; ``tools/quant_variants.py``); for #4 ``torch.mul(vals,
    scales)`` over the round's (R, 128) and (R, 1) buffers in ONE call,
    the yardstick, and per leaf as a second reading. The host's
    microseconds per round, the wrapper and the per-leaf calls in turns.
    #5-6 per round as before (one three-pass / one launch per padded
    leaf), #6 in turns with ``torch.mul`` per leaf; then #6 over ONE
    buffer of the round's 60,965,376 elements, one launch, in turns with
    one ``torch.mul(vals, scale)`` (the card's own time), and #5 over the
    same buffer, its one launch in turns with the three-pass launcher it
    replaced. Each against the bytes bound and its plain version."""
    import torch
    from theanompi_tpu_torch.ops import quant as tq
    from theanompi_tpu_torch.tools import quant_variants as qv

    xs = qv.round_leaves(dev)
    lengths = [x.numel() for x in xs]
    x2ds = [tq.pad_rows(x) for x in xs]
    vals, scales, row0s = tq.quantize_int8_block_leaves(xs)
    back, outs = qv.out_views(row0s, lengths, dev)
    pairs = [(vals[r0:r0 + x.shape[0]], scales[r0:r0 + x.shape[0]]) for r0, x in zip(row0s, x2ds)]
    v5 = [tq.quantize_int8(x) for x in x2ds]
    elems = sum(x.numel() for x in x2ds)  # the padded rows, as the kernels write them
    rows = elems // 128
    block_bytes = elems * 5 + rows * 4  # f32 in, int8 + one f32 scale per row out (or back)
    whole_bytes = elems * 5 + len(xs) * 4
    ops = elems * 4  # |x|, max, divide, round (and clamp) per element
    q_buf = (torch.empty_like(vals), torch.empty_like(scales))
    specs = {
        "quant_block": dict(
            kernel=lambda: tq.quantize_int8_block_leaves(xs),
            table_built=qv.prepare(None, "quantize", xs, *q_buf, outs, row0s),
            per_leaf=lambda: qv.per_leaf_quantize(x2ds), library=None,
            plain=lambda: tq.quantize_int8_block_leaves_plain(xs), bytes=block_bytes, ops=ops),
        "dequant_block": dict(
            kernel=lambda: tq.dequantize_int8_block_leaves(vals, scales, outs, row0s),
            table_built=qv.prepare(None, "dequantize", xs, vals, scales, outs, row0s),
            per_leaf=lambda: qv.per_leaf_dequantize(pairs),
            library=lambda: torch.mul(vals, scales, out=back.view(rows, 128)),
            library_per_leaf=lambda: [torch.mul(v, s) for v, s in pairs],
            plain=lambda: tq.dequantize_int8_block_leaves_plain(vals, scales, outs, row0s),
            bytes=block_bytes, ops=elems),
        "quant": dict(kernel=lambda: [tq.quantize_int8(x) for x in x2ds], library=None,
                      plain=lambda: [tq.quantize_int8_plain(x) for x in x2ds],
                      bytes=whole_bytes, ops=ops),
        "dequant": dict(kernel=lambda: [tq.dequantize_int8(v, s) for v, s in v5],
                        library=lambda: [torch.mul(v, s) for v, s in v5],
                        plain=lambda: [tq.dequantize_int8_plain(v, s) for v, s in v5],
                        bytes=whole_bytes, ops=elems),
    }
    results = {}
    for name, sp in specs.items():
        ways = {k: sp[k] for k in ("kernel", "table_built", "per_leaf", "library",
                                   "library_per_leaf") if sp.get(k) is not None}
        turns = {k: [] for k in ways}
        for _ in range(2 if "per_leaf" in ways else 3):
            for k, fn in ways.items():
                turns[k].append(cuda_ms(fn, reps=20))
        mean = {k: sum(v) / len(v) for k, v in turns.items()}
        plain_ms = cuda_ms(sp["plain"], reps=5)
        bytes_ms, ops_ms = sp["bytes"] / mem_rate * 1e3, sp["ops"] / fp32_peak * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        res = dict(step_ms=mean["kernel"], plain_ms=plain_ms, library_ms=mean.get("library"),
                   bound_ms=bound_ms, bytes=sp["bytes"], turns_ms=turns,
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        line = (f"[times] {name}: {mean['kernel']:.4f} ms per round ({elems} elements) | bound "
                f"{bound_ms:.4f} ms ({sp['bytes'] / 1e6:.1f} MB; {res['bound_by']}) | "
                f"{bound_ms / mean['kernel'] * 100:.1f}% of bound | plain {plain_ms:.4f} ms")
        if "per_leaf" in ways:
            host = {"kernel": [], "per_leaf": []}
            for _ in range(2):
                for k in host:
                    host[k].append(host_us(ways[k]))
            host_mean = {k: sum(v) / len(v) for k, v in host.items()}
            res.update(table_built_ms=mean["table_built"], per_leaf_ms=mean["per_leaf"],
                       host_us_per_round=host_mean, host_us_turns=host)
            line += (f" | table built once (device alone) {mean['table_built']:.4f} ms "
                     f"({bound_ms / mean['table_built'] * 100:.1f}%) | 16 one-leaf calls "
                     f"{mean['per_leaf']:.4f} ms | host us per round {host_mean['kernel']:.1f} "
                     f"(1 launch) vs {host_mean['per_leaf']:.1f} (16), "
                     f"{host_mean['per_leaf'] / host_mean['kernel']:.2f}x")
        if "library_per_leaf" in ways:
            res["library_per_leaf_ms"] = mean["library_per_leaf"]
            line += (f" | library torch.mul(vals, scales) in one call {mean['library']:.4f} ms, "
                     f"{mean['kernel'] / mean['library']:.3f}x (device alone "
                     f"{mean['table_built'] / mean['library']:.3f}x); per leaf "
                     f"{mean['library_per_leaf']:.4f} ms")
        else:
            line += (f" | library torch.mul(vals, scales) per leaf {mean['library']:.4f} ms, "
                     f"{mean['kernel'] / mean['library']:.3f}x" if "library" in ways else
                     " | library none")
        print(line + f" | turns {turns}", flush=True)
        results[name] = res
    # #6 over ONE buffer of the round's elements (the card's own time,
    # one launch) in turns with one torch.mul(vals, scale), the same
    # function, bit for bit
    v_one, s_one = tq.quantize_int8(torch.cat(x2ds))
    check(bits_equal(tq.dequantize_int8(v_one, s_one), torch.mul(v_one, s_one)),
          "dequant over one buffer differs from torch.mul(vals, scale)")
    ways = {"kernel": lambda: tq.dequantize_int8(v_one, s_one),
            "library": lambda: torch.mul(v_one, s_one)}
    turns = {k: [] for k in ways}
    for k in ("kernel", "library", "library", "kernel"):
        turns[k].append(cuda_ms(ways[k], reps=20))
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    one_bytes = elems * 5 + 4  # int8 in, f32 out, the scale
    bound_ms = one_bytes / mem_rate * 1e3
    plain_ms = cuda_ms(lambda: tq.dequantize_int8_plain(v_one, s_one), reps=5)
    results["dequant_one_buffer"] = dict(
        step_ms=mean["kernel"], library_ms=mean["library"], plain_ms=plain_ms, bound_ms=bound_ms,
        bytes=one_bytes, bound_by="bytes", turns_ms=turns, rows=rows, elements=elems)
    print(f"[times] dequant over one ({rows}, 128) buffer ({elems} elements, one launch): "
          f"{mean['kernel']:.4f} ms | bound {bound_ms:.4f} ms ({one_bytes / 1e6:.1f} MB; bytes) | "
          f"{bound_ms / mean['kernel'] * 100:.1f}% of bound | torch.mul(vals, scale) "
          f"{mean['library']:.4f} ms, {mean['kernel'] / mean['library']:.3f}x | plain "
          f"{plain_ms:.4f} ms | turns (kernel, library, library, kernel) {turns}", flush=True)
    del v_one, s_one
    # #5 over the same ONE buffer: the one-launch kernel in turns with the
    # three-pass launcher it replaced (old, new, new, old), both bit for
    # bit the plain version's
    x_one = torch.cat(x2ds)
    pv, ps = tq.quantize_int8_plain(x_one)
    ways = {"kernel": lambda: tq.quantize_int8(x_one),
            "three_pass": lambda: tq._quantize_int8_three_pass(x_one)}
    for k, fn in ways.items():
        v_k, s_k = fn()
        check(bits_equal(v_k, pv) and bits_equal(s_k, ps),
              f"#5 {k} over one buffer differs from the plain version")
    del pv, ps, v_k, s_k
    turns = {k: [] for k in ways}
    for k in ("three_pass", "kernel", "kernel", "three_pass"):
        turns[k].append(cuda_ms(ways[k], reps=20))
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    one_bytes = elems * 5 + 4  # f32 in, int8 out, the scale: each byte once
    bound_ms = one_bytes / mem_rate * 1e3
    floor_ms = (elems * 9 + 4) / mem_rate * 1e3  # the input read twice
    plain_ms = cuda_ms(lambda: tq.quantize_int8_plain(x_one), reps=5)
    results["quant_one_buffer"] = dict(
        step_ms=mean["kernel"], three_pass_ms=mean["three_pass"], plain_ms=plain_ms,
        bound_ms=bound_ms, two_read_floor_ms=floor_ms, bytes=one_bytes, bound_by="bytes",
        turns_ms=turns, rows=rows, elements=elems)
    print(f"[times] quant over one ({rows}, 128) buffer ({elems} elements): one launch "
          f"{mean['kernel']:.4f} ms, the three-pass launcher {mean['three_pass']:.4f} ms "
          f"({mean['three_pass'] / mean['kernel']:.3f}x) | bound {bound_ms:.4f} ms "
          f"({one_bytes / 1e6:.1f} MB; bytes): {bound_ms / mean['kernel'] * 100:.1f}% / "
          f"{bound_ms / mean['three_pass'] * 100:.1f}% of it | two reads and a write "
          f"{floor_ms:.4f} ms | plain {plain_ms:.4f} ms | library none | turns (three_pass, "
          f"kernel, kernel, three_pass) {turns}", flush=True)
    del x_one
    torch.cuda.synchronize()
    return results


# (q_off, k_off) of the ring hops in flash_cases: below, on and above the
# causal diagonal (the last: a hop wholly in the future)
RING_HOPS = ((512, 256), (512, 512), (256, 512))


def whole_future(Tq, causal, q_off, k_off) -> bool:
    """Every key of the hop lies in the future of every query."""
    return causal and k_off >= q_off + Tq


def flash_cases():
    """(label, BH, Tq, Tk, D, causal, q_off, k_off, dtype): the 136M LM's
    shape in bf16 and fp32, the 350M LM's in bf16, ragged T and D, Tq != Tk, causal and not,
    nonzero offsets with rows that see no key, Tq 200 and 1000 (ragged
    128-row Q tiles of flash_fwd_sm90), bf16 heads of 60, 36 and 33
    (flash_fwd_mma_bf16, flash_dq_mma_bf16 and flash_dkv_mma_bf16: 4-byte
    copies, and register-staged loads for the odd head) with ragged T, Tq
    != Tk and offsets, fp32 heads of 30 and 33
    (flash_fwd_mma's and flash_dkv_mma's 4-byte copies), T = 8192
    (where the reference's backward switches to its 2-D kernels #10 and
    #11), and the ring hops of the 136M LM at --sp 4 (BH 96, Tq = Tk =
    256, bf16) at ``RING_HOPS``, with the fp32 and D 60 routes at BH 4."""
    import torch

    bh = LM_SHAPE["B"] * LM_SHAPE["H"]
    T, D = LM_SHAPE["T"], LM_SHAPE["D"]
    out = []
    for dt in (torch.bfloat16, torch.float32):
        out.append((f"136M shape {str(dt)[6:]}", bh, T, T, D, True, 0, 0, dt))
        for causal in (True, False):
            out.append((f"ragged T 200 D 40 {str(dt)[6:]}", 6, 200, 200, 40, causal, 0, 0, dt))
            out.append((f"Tq 130 Tk 250 D 48 {str(dt)[6:]}", 4, 130, 250, 48, causal, 0, 0, dt))
        out.append((f"offsets q 0 k 100, rows 0-99 blind {str(dt)[6:]}", 4, 192, 192, 64, True,
                    0, 100, dt))
        out.append((f"offsets q 160 k 0 {str(dt)[6:]}", 4, 96, 200, 64, True, 160, 0, dt))
    # the 350M LM's attention shape (phase lm350-main): batch 8, 16 heads of 64
    out.append(("350M shape bfloat16", LM350_SHAPE["B"] * LM350_SHAPE["H"], LM350_SHAPE["T"],
                LM350_SHAPE["T"], LM350_SHAPE["D"], True, 0, 0, torch.bfloat16))
    out.append(("ragged T 200 D 30 float32", 6, 200, 200, 30, True, 0, 0, torch.float32))
    out.append(("Tq 130 Tk 250 D 33 float32", 4, 130, 250, 33, True, 0, 0, torch.float32))
    bf = torch.bfloat16
    for causal in (True, False):
        out.append(("Tq 200 D 64 bfloat16", 6, 200, 200, 64, causal, 0, 0, bf))
    out.append(("Tq 1000 D 64 bfloat16", 8, 1000, 1000, 64, True, 0, 0, bf))
    out.append(("offsets q 160 k 0, Tq 200 Tk 360 bfloat16", 4, 200, 360, 64, True, 160, 0, bf))
    out.append(("ragged T 200 D 60 bfloat16", 6, 200, 200, 60, True, 0, 0, bf))
    out.append(("Tq 130 Tk 250 D 60 bfloat16", 4, 130, 250, 60, False, 0, 0, bf))
    out.append(("offsets q 160 k 0, Tq 200 Tk 360 D 60 bfloat16", 4, 200, 360, 60, True, 160, 0,
                bf))
    for causal in (True, False):
        out.append(("ragged T 200 D 36 bfloat16", 6, 200, 200, 36, causal, 0, 0, bf))
        out.append(("ragged T 200 D 33 bfloat16", 6, 200, 200, 33, causal, 0, 0, bf))
    out.append(("offsets q 0 k 100, rows 0-99 blind D 33 bfloat16", 4, 192, 192, 33, True, 0, 100,
                bf))
    out.append(("offsets q 160 k 0 D 36 bfloat16", 4, 96, 200, 36, True, 160, 0, bf))
    out.append(("T 8192 bfloat16", 2, 8192, 8192, 64, True, 0, 0, bf))
    # the ring's hops of the 136M LM at --sp 4 (phase sp): Tq = Tk = 256 a
    # rank, rank 2 folding the block of rank 1, its own (the diagonal), and
    # the block of rank 2 seen from rank 1: every key in the future of every
    # query (no tile for any CTA of the forward or dq; exact zeros)
    for q_off, k_off in RING_HOPS:
        out.append((f"ring hop q {q_off} k {k_off} bfloat16", 96, 256, 256, 64, True, q_off,
                    k_off, bf))
    for dt, D in ((torch.float32, 64), (bf, 60)):
        for q_off, k_off in RING_HOPS:
            out.append((f"ring hop q {q_off} k {k_off} D {D} {str(dt)[6:]}", 4, 256, 256, D,
                        True, q_off, k_off, dt))
    return out


def _rel_excess(got, want, rtol, atol):
    """max(|got - want| - rtol |want|) / atol: <= 1 passes."""
    return ((got.float() - want.float()).abs() - rtol * want.float().abs()).max().item() / atol


def bf16_o_excess(o, po, weight) -> float:
    """The bf16 forward's error as a share of its tolerance (<= 1 passes):
    1 bf16 ulp of the plain value, plus 2^-9 of ``weight`` = sum_i p_i
    |v_i| / l per element. The kernel sums q.k on the tensor cores in
    another order than the plain version, so the fp32 logits differ in
    their last bits and a probability near a bf16 rounding boundary can
    round to its neighbour (2^-8 to 2^-7 of itself) on one side only;
    each such p moves o by that share of p_i |v_i| / l. Few p flip at
    once: the worst reading on the H100 was 0.0785 of the 2^-7 limit, so
    2^-9 keeps about 3x headroom."""
    import torch

    w = po.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp_min(w, 1e-30))) - 7)
    excess = (o.float() - po.float()).abs() - ulp
    return (excess / torch.clamp_min(2.0 ** -9 * weight, 1e-30)).max().item()


def bf16_dv_control(q, k, v, do, lse, dsum, kw):
    """dv as a kernel that rounds p to bf16 before the dv product would
    compute it: bf16(p)^T . dO with fp32 sums. The reference keeps that
    product fp32 x fp32 with p unrounded (pallas_attention.py:227-230), so
    this is the wrong function, and phase flash's dv check must refuse it."""
    from theanompi_tpu_torch.ops import flash_attention as fa

    p, _ = fa._probs_and_ds(q, k, v, do, lse, dsum, kw["causal"], kw["scale"], kw["q_off"],
                            kw["k_off"])
    return fa._dot(p.to(v.dtype).transpose(1, 2), do)


# bf16 heads of D % 8 != 0 (and 2) against (BH, Tq, Tk, q_off, k_off):
# ragged, Tq != Tk both ways, rows blind to every key, a Q tile past Tk
SWEEP_HEADS = (1, 2, 7, 15, 17, 31, 47, 55, 63)
SWEEP_SHAPES = ((2, 130, 70, 0, 0), (2, 70, 200, 0, 0), (2, 150, 150, 40, 0),
                (2, 150, 150, 0, 90), (1, 257, 129, 128, 0))


def bf16_backward_head_sweep(dev, g) -> list:
    """flash_dq_mma_bf16 and flash_dkv_mma_bf16 (through their launchers)
    against the plain versions at every head of SWEEP_HEADS and shape of
    SWEEP_SHAPES, causal and not, from aligned tensors and from views one
    bf16 element past them (the register-staged loads for even D too), at
    phase flash's bf16 limits. A single visible key is left out: there p
    = 1 and dp = dsum exactly, so ds is rounding noise on both sides.
    Returns the failures."""
    import torch
    from theanompi_tpu_torch.ops import flash_attention as fa

    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    failures, cases = [], 0
    for D in SWEEP_HEADS:
        for BH, Tq, Tk, q_off, k_off in SWEEP_SHAPES:
            for causal in (True, False):
                for off in (0, 1):
                    def rows(T):
                        x = torch.randn(BH * T * D + 1, generator=g, device=dev)
                        return x.to(torch.bfloat16)[off:off + BH * T * D].view(BH, T, D)

                    q, k, v, do = rows(Tq), rows(Tk), rows(Tk), rows(Tq)
                    kw = dict(causal=causal, scale=1.0 / math.sqrt(D), q_off=q_off, k_off=k_off)
                    po, plse = fa.flash_fwd_plain(q, k, v, **kw)
                    dsum = torch.sum(do.float() * po.float(), dim=-1)
                    got = (fa._launch_dq_mma_bf16(q, k, v, do, plse, dsum, **kw),
                           *fa._launch_dkv_mma_bf16(q, k, v, do, plse, dsum, **kw))
                    want = (fa.flash_dq_plain(q, k, v, do, plse, dsum, **kw),
                            *fa.flash_dkv_plain(q, k, v, do, plse, dsum, **kw))
                    x = {n_: _rel_excess(a, b, 1e-4, at * b.abs().max().item())
                         if bool(torch.isfinite(a).all()) else math.inf
                         for n_, a, b, at in zip(("dq", "dk", "dv"), got, want,
                                                 (2.0 ** -9, 2.0 ** -9, 1e-5))}
                    cases += 1
                    for n_, r in x.items():
                        worst[n_] = max(worst[n_], r)
                    if max(x.values()) > 1:
                        failures.append(f"head sweep D {D} BH {BH} Tq {Tq} Tk {Tk} offsets "
                                        f"{q_off}/{k_off} causal {causal} view +{off}: {x}")
    torch.cuda.synchronize()
    print(f"[flash] bf16 backward head sweep: {cases} cases (D {SWEEP_HEADS}), worst share of "
          f"the limits { {n_: round(r, 4) for n_, r in worst.items()} }, "
          f"{len(failures)} failed", flush=True)
    return failures


def fp32_dq_head_sweep(dev, g) -> list:
    """flash_dq_mma (through its launcher) against flash_dq_plain at every
    head of SWEEP_HEADS and shape of SWEEP_SHAPES, causal and not, from
    aligned tensors and from views one fp32 element past them (4-byte
    copies at every D), at phase flash's fp32 dq limit (rtol 1e-4 + 1e-5
    of the largest value). Returns the failures."""
    import torch
    from theanompi_tpu_torch.ops import flash_attention as fa

    worst, failures, cases = 0.0, [], 0
    for D in SWEEP_HEADS:
        for BH, Tq, Tk, q_off, k_off in SWEEP_SHAPES:
            for causal in (True, False):
                for off in (0, 1):
                    def rows(T):
                        x = torch.randn(BH * T * D + 1, generator=g, device=dev)
                        return x[off:off + BH * T * D].view(BH, T, D)

                    q, k, v, do = rows(Tq), rows(Tk), rows(Tk), rows(Tq)
                    kw = dict(causal=causal, scale=1.0 / math.sqrt(D), q_off=q_off, k_off=k_off)
                    po, plse = fa.flash_fwd_plain(q, k, v, **kw)
                    dsum = torch.sum(do * po, dim=-1)
                    got = fa._launch_dq_mma(q, k, v, do, plse, dsum, **kw)
                    want = fa.flash_dq_plain(q, k, v, do, plse, dsum, **kw)
                    x = (_rel_excess(got, want, 1e-4, 1e-5 * want.abs().max().item())
                         if bool(torch.isfinite(got).all()) else math.inf)
                    cases += 1
                    worst = max(worst, x)
                    if x > 1:
                        failures.append(f"fp32 dq sweep D {D} BH {BH} Tq {Tq} Tk {Tk} offsets "
                                        f"{q_off}/{k_off} causal {causal} view +{off}: {x:.3g}")
    torch.cuda.synchronize()
    print(f"[flash] fp32 dq head sweep: {cases} cases (D {SWEEP_HEADS}), worst share of the "
          f"limit {worst:.4f}, {len(failures)} failed", flush=True)
    return failures


# the generic kernels, on no route: held to the routes' limits through
# their own launchers, and timed in turns against the kernels that
# replaced them
GENERIC_FLASH = ("flash_fwd", "flash_dq", "flash_dkv")


def phase_flash(dev):
    """Each flash kernel against its plain version on the card; every case
    runs and prints, then any failure ends the phase.

    bf16 limits: o 1 ulp + 2^-9 sum p|v|/l (``bf16_o_excess``); dq and dk
    rtol 1e-4 + 2^-9 of the largest value, since a p that differs in its
    last fp32 bit can round ds to the neighbouring bf16 value (a term off
    by 2^-8 of itself; the worst reading on the H100 under 2^-8 was
    0.169); dv, an fp32 x fp32 product of the unrounded p, the fp32 limit
    rtol 1e-4 + 1e-5 of the largest value. At the 136M shape a control,
    dv with p rounded to bf16 (``bf16_dv_control``), must fail that dv
    check. The counters must show each case's routes: bf16 with D % 8 ==
    0 on flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90; fp32 on
    flash_fwd_mma, flash_dq_mma and flash_dkv_mma; the other bf16 heads on
    flash_fwd_mma_bf16, flash_dq_mma_bf16 and flash_dkv_mma_bf16. On those
    heads the generic flash_fwd, flash_dq and flash_dkv (the kernels these
    heads took before), and on every fp32 case the generic flash_dq (the
    fp32 dq's kernel before flash_dq_mma), are held to the same limits
    through their own launchers (outside the counted calls). Last, the
    bf16 backward's head sweep (``bf16_backward_head_sweep``) and the fp32
    dq's (``fp32_dq_head_sweep``)."""
    import torch
    from theanompi_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(8)
    counters = (fa.FLASH_FWD, fa.FLASH_FWD_SM90, fa.FLASH_FWD_MMA, fa.FLASH_FWD_MMA_BF16,
                fa.FLASH_DQ, fa.FLASH_DQ_SM90, fa.FLASH_DQ_MMA, fa.FLASH_DQ_MMA_BF16,
                fa.FLASH_DKV, fa.FLASH_DKV_SM90, fa.FLASH_DKV_MMA, fa.FLASH_DKV_MMA_BF16)
    names = tuple(c.name for c in counters)
    worst = dict.fromkeys(names, 0.0)
    # every counter but the three generic kernels' is some case's route
    routes = dict.fromkeys((n_ for n_ in names if n_ not in GENERIC_FLASH), 0)
    # the bf16 cases' worst share of each tolerance, and the control's
    readings = {"o": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0, "dv_control": None}
    failures = []
    for label, BH, Tq, Tk, D, causal, q_off, k_off, dt in flash_cases():
        q = torch.randn(BH, Tq, D, generator=g, device=dev).to(dt)
        k = torch.randn(BH, Tk, D, generator=g, device=dev).to(dt)
        v = torch.randn(BH, Tk, D, generator=g, device=dev).to(dt)
        do = torch.randn(BH, Tq, D, generator=g, device=dev).to(dt)
        kw = dict(causal=causal, scale=1.0 / math.sqrt(D), q_off=q_off, k_off=k_off)
        before = tuple(c.launches for c in counters)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        po, plse = fa.flash_fwd_plain(q, k, v, **kw)
        dsum = torch.sum(do.float() * po.float(), dim=-1)
        dq = fa.flash_dq(q, k, v, do, plse, dsum, **kw)
        dk, dv = fa.flash_dkv(q, k, v, do, plse, dsum, **kw)
        pdq = fa.flash_dq_plain(q, k, v, do, plse, dsum, **kw)
        pdk, pdv = fa.flash_dkv_plain(q, k, v, do, plse, dsum, **kw)
        torch.cuda.synchronize()
        after = tuple(c.launches for c in counters)
        bad = []
        if dt == torch.float32:
            fwd, dqk, dkv = "flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma"
        elif D % 8 == 0:
            fwd, dqk, dkv = "flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90"
        else:
            fwd, dqk, dkv = "flash_fwd_mma_bf16", "flash_dq_mma_bf16", "flash_dkv_mma_bf16"
        want = tuple(int(n_ in (fwd, dqk, dkv)) for n_ in names)
        if tuple(b - a for a, b in zip(before, after)) != want:
            bad.append(f"counters {names} moved {before} -> {after}, expected + {want}")
        for n_ in (fwd, dqk, dkv):
            routes[n_] += 1
        for name, t in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
            if not bool(torch.isfinite(t).all()):
                bad.append(f"non-finite {name}")
        lse_err = (lse - plse).abs().max().item()
        if lse_err > 1e-5:
            bad.append(f"lse off by {lse_err:.3g} > 1e-5")
        if k_off > q_off:  # the blind rows: o = 0 and the sentinel lse
            blind = k_off - q_off
            if o[:, :blind].float().any() or not bool((lse[:, :blind] <= -1e29).all()):
                bad.append("rows that see no key are not o = 0, lse ~ -1e30")
        grads = ((dq, pdq), (dk, pdk), (dv, pdv))
        grad_x = 0.0
        if whole_future(Tq, causal, q_off, k_off):
            # no CTA has a tile: every output comes from the epilogues alone
            for name, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
                if t.float().any():
                    bad.append(f"whole-future hop: {name} not exactly 0")
            for name, t in (("plain o", po), ("plain dq", pdq), ("plain dk", pdk),
                            ("plain dv", pdv)):
                if t.float().any():
                    bad.append(f"whole-future hop: {name} not exactly 0")
            tol = "whole-future hop: o, dq, dk, dv exactly 0 and lse <= -1e29"
        elif dt == torch.float32:
            o_x = _rel_excess(o, po, 1e-5, 1e-6 * po.abs().max().item())
            grad_x = max(_rel_excess(a, b, 1e-4, 1e-5 * b.abs().max().item()) for a, b in grads)
            if o_x > 1:
                bad.append(f"o beyond rtol 1e-5 + 1e-6 max|o| (x{o_x:.3g})")
            if grad_x > 1:
                bad.append(f"dq/dk/dv beyond rtol 1e-4 + 1e-5 max (x{grad_x:.3g})")
            # the generic flash_dq, the fp32 dq's kernel before flash_dq_mma
            dqg = fa._launch_dq_generic(q, k, v, do, plse, dsum, **kw)
            torch.cuda.synchronize()
            gdq_x = _rel_excess(dqg, pdq, 1e-4, 1e-5 * pdq.abs().max().item())
            worst["flash_dq"] = max(worst["flash_dq"], (dqg - pdq).abs().max().item())
            if gdq_x > 1:
                bad.append(f"generic flash_dq beyond rtol 1e-4 + 1e-5 max (x{gdq_x:.3g})")
            del dqg
            tol = f"fp32 o at {o_x:.3g}; generic flash_dq at {gdq_x:.3g}"
        else:
            # sum_i p_i |v_i| / l: the fp32 forward of |v|
            weight, _ = fa.flash_fwd_plain(q.float(), k.float(), v.float().abs(), **kw)
            o_x = bf16_o_excess(o, po, weight)
            x = {"o": o_x,
                 "dq": _rel_excess(dq, pdq, 1e-4, 2.0 ** -9 * pdq.abs().max().item()),
                 "dk": _rel_excess(dk, pdk, 1e-4, 2.0 ** -9 * pdk.abs().max().item()),
                 "dv": _rel_excess(dv, pdv, 1e-4, 1e-5 * pdv.abs().max().item())}
            for n_, r in x.items():
                readings[n_] = max(readings[n_], r)
            grad_x = max(x["dq"], x["dk"], x["dv"])
            if o_x > 1:
                bad.append(f"o beyond 1 bf16 ulp + 2^-9 sum p|v|/l (x{o_x:.3g})")
            if max(x["dq"], x["dk"]) > 1:
                bad.append(f"dq/dk beyond rtol 1e-4 + 2^-9 max (x{max(x['dq'], x['dk']):.3g})")
            if x["dv"] > 1:
                bad.append(f"dv beyond rtol 1e-4 + 1e-5 max (x{x['dv']:.3g})")
            tol = f"bf16 o at {o_x:.3g}, dq {x['dq']:.3g}, dk {x['dk']:.3g}, dv {x['dv']:.3g}"
            if fwd == "flash_fwd_mma_bf16":
                # the generic kernels these heads took before, held to the same limits
                og, lseg = fa._launch_fwd_generic(q, k, v, **kw)
                og_x = bf16_o_excess(og, po, weight)
                lseg_err = (lseg - plse).abs().max().item()
                dqg = fa._launch_dq_generic(q, k, v, do, plse, dsum, **kw)
                dkg, dvg = fa._launch_dkv_generic(q, k, v, do, plse, dsum, **kw)
                torch.cuda.synchronize()
                gx = {"dq": _rel_excess(dqg, pdq, 1e-4, 2.0 ** -9 * pdq.abs().max().item()),
                      "dk": _rel_excess(dkg, pdk, 1e-4, 2.0 ** -9 * pdk.abs().max().item()),
                      "dv": _rel_excess(dvg, pdv, 1e-4, 1e-5 * pdv.abs().max().item())}
                for n_, e in (("flash_fwd", (og.float() - po.float()).abs().max().item()),
                              ("flash_dq", (dqg - pdq).abs().max().item()),
                              ("flash_dkv", max((dkg - pdk).abs().max().item(),
                                                (dvg - pdv).abs().max().item()))):
                    worst[n_] = max(worst[n_], e)
                tol += (f"; generic flash_fwd o at {og_x:.3g}, lse off by {lseg_err:.3g}, "
                        f"flash_dq {gx['dq']:.3g}, flash_dkv dk {gx['dk']:.3g} dv {gx['dv']:.3g}")
                if og_x > 1 or lseg_err > 1e-5:
                    bad.append(f"generic flash_fwd beyond the bf16 limits (o x{og_x:.3g}, lse "
                               f"{lseg_err:.3g})")
                if max(gx.values()) > 1:
                    bad.append(f"generic flash_dq / flash_dkv beyond the bf16 limits ({gx})")
                del og, lseg, dqg, dkg, dvg
            del weight
            if label.startswith("136M shape"):
                ctrl = bf16_dv_control(q, k, v, do, plse, dsum, kw)
                readings["dv_control"] = _rel_excess(ctrl, pdv, 1e-4, 1e-5 * pdv.abs().max().item())
                del ctrl
                tol += f"; control bf16(p) dv at {readings['dv_control']:.3g}"
                if readings["dv_control"] <= 1:
                    bad.append("the bf16(p) dv control passes the dv check: it sees no cast point")
        errs = {fwd: (o.float() - po.float()).abs().max().item(),
                dqk: (dq - pdq).abs().max().item(),
                dkv: max((dk - pdk).abs().max().item(), (dv - pdv).abs().max().item())}
        for n_, e in errs.items():
            worst[n_] = max(worst[n_], e)
        print(f"  {label:42s} BH {BH:3d} Tq {Tq:5d} Tk {Tk:5d} D {D:3d} causal {causal!s:5s} "
              f"[{fwd}, {dqk}, {dkv}]: max abs err o {errs[fwd]:.3g} (max|o| "
              f"{po.float().abs().max().item():.3g}) lse {lse_err:.3g} dq {errs[dqk]:.3g} "
              f"dk/dv {errs[dkv]:.3g} "
              f"({tol}; grads at {grad_x:.3g} of the tolerance)"
              + (f" FAILED: {'; '.join(bad)}" if bad else ""), flush=True)
        failures += [f"{label}: {b}" for b in bad]
        del q, k, v, do, o, po, dq, dk, dv, pdq, pdk, pdv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    failures += bf16_backward_head_sweep(dev, g)
    failures += fp32_dq_head_sweep(dev, g)
    check(readings["dv_control"] is not None, "no 136M-shape bf16 case ran the dv control")
    check(all(routes.values()), f"a forward, dq or dk/dv route ran no case: {routes}")
    check(not failures, "flash kernels differ from their plain versions: " + " | ".join(failures))
    print(f"[flash] cases per route: {routes}", flush=True)
    return worst, readings


def phase_lm_main():
    """Full-width TransformerLM_136M through the CLI, counters zeroed just
    before the run and read just after."""
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    argv = ["BSP", "1", "transformer_lm", "TransformerLM_136M", "--synthetic",
            "--max-steps", str(LM_STEPS), "--print-freq", "1", "--seed", "0",
            "--dataset-arg", "n_train=64", "--dataset-arg", f"n_val={LM_VAL}"]
    print(f"[lm-main] python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
    reset_launch_counts()
    summary = run_cli(argv)
    counts = launch_counts()
    losses = summary["losses"]
    check(summary["steps"] == LM_STEPS and len(losses) == LM_STEPS
          and all(math.isfinite(x) for x in losses) and summary["nonfinite_steps"] == 0,
          f"lm run: steps {summary['steps']}, losses {losses}")
    check("val" in summary and all(math.isfinite(v) for v in summary["val"].values()),
          f"lm run: bad val metrics {summary.get('val')}")
    val_batches = 1
    want = {"flash_fwd_sm90": LM_LAYERS * (LM_STEPS + val_batches), "flash_fwd": 0,
            "flash_fwd_mma": 0, "flash_fwd_mma_bf16": 0,
            "flash_dq_sm90": LM_LAYERS * LM_STEPS, "flash_dq": 0, "flash_dq_mma": 0,
            "flash_dq_mma_bf16": 0,
            "flash_dkv_sm90": LM_LAYERS * LM_STEPS, "flash_dkv": 0, "flash_dkv_mma": 0,
            "flash_dkv_mma_bf16": 0}
    got = {k: counts[k] for k in want}
    check(got == want, f"lm run launched {got}, expected {want}")
    stray = {k: v for k, v in counts.items() if k not in want and v}
    check(not stray, f"the lm run launched other kernels: {stray}")
    tokens_per_sec = summary["images_per_sec"] * LM_SHAPE["T"]
    print(f"[lm-main] per-step loss {losses}; val {summary['val']}", flush=True)
    print(f"[lm-main] steady-state step {summary['step_ms']:.3f} ms over {summary['steady_steps']} "
          f"steps (CUDA events, 2 warm-up steps excluded), {summary['images_per_sec']:.2f} seq/s = "
          f"{tokens_per_sec:.0f} tokens/s, launches {counts}", flush=True)
    return {"launches": got, "summary": summary, "tokens_per_sec": tokens_per_sec}


LM_PARITY_FLASH = ("flash_fwd_mma", "flash_fwd_mma_bf16", "flash_fwd", "flash_fwd_sm90",
                   "flash_dq", "flash_dq_sm90", "flash_dq_mma", "flash_dq_mma_bf16", "flash_dkv",
                   "flash_dkv_sm90", "flash_dkv_mma", "flash_dkv_mma_bf16")
LM_FP32_FLASH = ("flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma")
LM_BF16_D60_FLASH = ("flash_fwd_mma_bf16", "flash_dq_mma_bf16", "flash_dkv_mma_bf16")


def _lm_two_steps(recipe, dev) -> dict:
    """``recipe``'s LM trained 2 steps on the CPU and on ``dev`` from the
    same weights and batches: {device: (losses, params before, params
    after, launch counts)}."""
    import torch
    from theanompi_tpu_torch.models.lm import TransformerLMModel
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from theanompi_tpu_torch.train import init_train_state, make_train_step
    from theanompi_tpu_torch.tree import tree_leaves

    model = TransformerLMModel(recipe)
    vocab, T = recipe.num_classes, recipe.input_shape[0]
    rng = torch.Generator().manual_seed(9)
    batches = [torch.randint(0, vocab, (recipe.batch_size, T), generator=rng, dtype=torch.int32)
               for _ in range(2)]
    out = {}
    for d in ("cpu", dev):
        state = init_train_state(model, torch.Generator().manual_seed(10), d)
        before = [p.detach().cpu().clone() for p in tree_leaves(state.params)]
        step = make_train_step(model)
        reset_launch_counts()
        losses = []
        for x in batches:
            state, m = step(state, x.to(d), x.to(d), None)
            losses.append(float(m["loss"]))
        out[str(d)] = (losses, before, [p.detach().cpu() for p in tree_leaves(state.params)],
                       launch_counts())
    return out


def phase_lm_parity(dev):
    """A small fp32 LM trained 2 steps on the card (the flash kernels) and
    on the CPU (their plain versions) from the same weights and batches;
    then a bf16 LM with heads of 60 (the route of flash_fwd_mma_bf16,
    flash_dq_mma_bf16 and flash_dkv_mma_bf16) the same way. Returns each
    run's flash launches on the card."""
    import torch
    from theanompi_tpu_torch.models.lm import TransformerLMModel

    base = TransformerLMModel.default_recipe()
    recipe = base.replace(input_shape=(256,), num_classes=512, d_model=128, n_heads=2,
                          n_layers=2, d_ff=512, batch_size=4, attn="flash",
                          compute_dtype=torch.float32)
    out = _lm_two_steps(recipe, dev)
    (lc, bc, pc, kc), (lg, bg, pg, kg) = out["cpu"], out[str(dev)]
    check(not any(kc.values()), f"the CPU run launched kernels: {kc}")
    want = {n: 4 if n in LM_FP32_FLASH else 0 for n in LM_PARITY_FLASH}
    check({n: kg[n] for n in LM_PARITY_FLASH} == want,
          f"the card run launched {kg}, expected 4 of each fp32 flash kernel {LM_FP32_FLASH} "
          "and no other flash kernel")
    check(all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(lc, lg)),
          f"card losses {lg} vs CPU {lc}")
    worst = 0.0
    for i, (b0, a, b) in enumerate(zip(bc, pc, pg)):
        check(bool((b != b0).any()), f"leaf {i} did not change on the card")
        x = ((a - b).abs() - 1e-4 * a.abs()).max().item() / 1e-6
        worst = max(worst, x)
        check(x <= 1, f"leaf {i}: card params differ from CPU beyond atol 1e-6 + rtol 1e-4 "
                      f"(x{x:.3g})")
    print(f"[lm-parity] fp32: losses card {lg} vs CPU {lc}; params within atol 1e-6 + rtol 1e-4 "
          f"(worst at {worst:.3g} of the tolerance); every leaf changed; launches "
          f"{ {n: kg[n] for n in LM_PARITY_FLASH if kg[n]} }", flush=True)
    launches = {"fp32": {n: kg[n] for n in LM_PARITY_FLASH}}

    # bf16 compute, heads of 60: rows of no whole 16-byte units
    recipe = base.replace(input_shape=(256,), num_classes=512, d_model=120, n_heads=2,
                          n_layers=2, d_ff=480, batch_size=4, attn="flash",
                          compute_dtype=torch.bfloat16)
    out = _lm_two_steps(recipe, dev)
    (lc, bc, pc, kc), (lg, bg, pg, kg) = out["cpu"], out[str(dev)]
    check(not any(kc.values()), f"the CPU run launched kernels: {kc}")
    want = {n: 4 if n in LM_BF16_D60_FLASH else 0 for n in LM_PARITY_FLASH}
    check({n: kg[n] for n in LM_PARITY_FLASH} == want,
          f"the bf16 D 60 card run launched {kg}, expected 4 each of {LM_BF16_D60_FLASH} and no "
          "other flash kernel")
    check(all(math.isfinite(x) for x in lg) and
          all(math.isclose(a, b, rel_tol=2e-2) for a, b in zip(lc, lg)),
          f"bf16 D 60: card losses {lg} vs CPU {lc} (rtol 2e-2)")
    for i, (b0, b) in enumerate(zip(bc, pg)):
        check(bool(torch.isfinite(b).all()) and bool((b != b0).any()),
              f"bf16 D 60: leaf {i} did not change on the card, or is not finite")
    d_cpu = torch.cat([(a - b0).flatten() for a, b0 in zip(pc, bc)])
    d_card = torch.cat([(b - b0).flatten() for b, b0 in zip(pg, bg)])
    rel = ((d_card - d_cpu).norm() / d_cpu.norm()).item()
    check(rel <= 0.1, f"bf16 D 60: the card's parameter change is {rel:.3g} of the CPU's away "
                      "from it in relative norm (> 0.1)")
    print(f"[lm-parity] bf16 D 60: losses card {lg} vs CPU {lc}; parameter change "
          f"{rel:.4g} of the CPU's from it (relative norm); every leaf changed; launches "
          f"{ {n: kg[n] for n in LM_PARITY_FLASH if kg[n]} }", flush=True)
    launches["bf16_d60"] = {n: kg[n] for n in LM_PARITY_FLASH}
    return launches


LM350_LAYERS = 24
LM350_STEPS = 4


def phase_lm350_main():
    """Full-width TransformerLM_350M (24 layers, d 1024, 16 heads of 64,
    remat) through the CLI: 4 steps and one validation batch. Under remat
    the backward runs each block's forward again, so flash_fwd_sm90
    launches 24 x 2 a step and 24 a validation batch; dq and dk/dv 24 a
    step; no other kernel."""
    import torch
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    argv = ["BSP", "1", "transformer_lm", "TransformerLM_350M", "--synthetic",
            "--max-steps", str(LM350_STEPS), "--print-freq", "1", "--seed", "0",
            "--dataset-arg", "n_train=64", "--dataset-arg", f"n_val={LM_VAL}"]
    print(f"[lm350-main] python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    summary = run_cli(argv)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = summary["losses"]
    check(summary["model"] == "transformer_lm_350m" and summary["steps"] == LM350_STEPS
          and len(losses) == LM350_STEPS and all(math.isfinite(x) for x in losses)
          and summary["nonfinite_steps"] == 0,
          f"lm350 run: steps {summary['steps']}, losses {losses}")
    check("val" in summary and all(math.isfinite(v) for v in summary["val"].values()),
          f"lm350 run: bad val metrics {summary.get('val')}")
    want = {n: 0 for n in LM_PARITY_FLASH}
    want.update(flash_fwd_sm90=LM350_LAYERS * (2 * LM350_STEPS + 1),
                flash_dq_sm90=LM350_LAYERS * LM350_STEPS,
                flash_dkv_sm90=LM350_LAYERS * LM350_STEPS)
    got = {k: counts[k] for k in want}
    check(got == want, f"lm350 run launched {got}, expected {want} (remat: the forward twice "
                       "a layer in a train step)")
    stray = {k: v for k, v in counts.items() if k not in want and v}
    check(not stray, f"the lm350 run launched other kernels: {stray}")
    tokens_per_sec = summary["images_per_sec"] * LM_SHAPE["T"]
    print(f"[lm350-main] per-step loss {losses}; val {summary['val']}", flush=True)
    print(f"[lm350-main] steady-state step {summary['step_ms']:.3f} ms over "
          f"{summary['steady_steps']} steps (CUDA events, 2 warm-up steps excluded), "
          f"{summary['images_per_sec']:.3f} seq/s = {tokens_per_sec:.0f} tokens/s; peak "
          f"allocated {peak / 2**30:.3f} GiB; launches {got}", flush=True)
    return {"launches": got, "summary": summary, "tokens_per_sec": tokens_per_sec,
            "peak_bytes": peak}



# phase sp: the 136M width at 2 layers on one card (2 gloo ranks, --sp 2);
# --only sp on 4 cards over NCCL at full depth
SP_LAYERS = 2
SP_STEPS = 3
SP4_STEPS = 32  # 30 steady steps: a window of >= 0.5 s at every mesh
SP4_K = 4  # steps a captured group
SP350_STEPS = 4
SP_LONG_T = 8192
SP_LONG_BATCH = 2
SP_LONG_STEPS = 4
SP_PROFILE_STEPS = 5
# the loss of the first step, --sp 2 against one rank: bf16 o rounded at
# each ring hop (or around the all-to-all) against once, on ~ln V
SP_LOSS_RTOL = 1e-3
SP_FLASH = ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90")


def successor_table():
    """The 136M LM's synthetic chain's successor table (``data/lm.py``),
    drawn in this process (~30 s once; the lm phases reuse it) and handed
    to the ranks of phase sp, which would each draw it again."""
    from theanompi_tpu_torch.data import lm as data_lm

    key = (32768, 4, 1234)  # vocab, branching, seed: the dataset's defaults
    return key, data_lm._successors(*key)


def sp_run_kwargs(attn, steps, layers=None, epoch_steps=None, **extra):
    """``run_training`` kwargs of an SP run of the 136M LM's width: one
    epoch of ``epoch_steps`` (default ``steps``) batches and one
    validation batch."""
    over = {"attn": attn}
    if layers is not None:
        over["n_layers"] = layers
    over.update(extra.pop("recipe", {}))
    batch = over.get("batch_size", 8)
    return dict(dataset="synthetic", max_steps=steps, print_freq=1, seed=0,
                recipe_overrides=over,
                dataset_kwargs={"n_train": batch * (epoch_steps or steps), "n_val": batch},
                **extra)


def sp_profile(rank, n, device, sp, attn, steps):
    """Device time of ``steps`` steps of the 12-layer 136M at ``--sp sp``
    after 3 warm-up steps, by ``torch.profiler``'s kernel names: NCCL's
    (the ring's point-to-point exchanges, the all-to-alls, the gradient
    all-reduce), the flash kernels', and every other kernel's; None where
    the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.models.lm import TransformerLM_136M
    from theanompi_tpu_torch.parallel.nd import NDEngine

    model = TransformerLM_136M(TransformerLM_136M.default_recipe().replace(attn=attn))
    eng = NDEngine(model, n, device, sp=sp)
    state = eng.init_state(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    B = 8 // eng.dp
    batches = [torch.randint(0, 32768, (B, 1024), generator=g).to(device) for _ in range(3 + steps)]
    for x in batches[:3]:
        state, _ = eng.train_step(state, x, x, None)
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for x in batches[3:]:
            state, _ = eng.train_step(state, x, x, None)
        end.record()
        torch.cuda.synchronize(device)
    cats = {"nccl_ms": 0.0, "flash_ms": 0.0, "other_kernels_ms": 0.0}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if not t or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        cat = "nccl_ms" if "nccl" in name else "flash_ms" if "flash" in name else \
            "other_kernels_ms"
        cats[cat] += t / 1e3 / steps
    wall = start.elapsed_time(end) / steps
    if not any(cats.values()):
        return {"step_ms": wall, "profiler": "no device time seen"}
    return {"step_ms": wall, **cats, "steps": steps}


def sp_rank(rank, n, device, table_key, table, runs, profiles=()):
    """One rank of phase sp: the parent's successor table in place of its
    own draw, then each run of ``runs`` (``(label, modelclass, kwargs)``)
    through ``run_training`` over the run's mesh, and each ``profiles``
    entry ``(label, sp, attn)`` through ``sp_profile``. ``kwargs`` with
    ``devices`` 1 run on rank 0 alone while the others wait."""
    import torch
    import torch.distributed as dist

    from theanompi_tpu_torch.data import lm as data_lm
    from theanompi_tpu_torch.launch.session import resolve_model
    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.ops.kernels import reset_launch_counts

    draw = data_lm._successors

    def successors(vocab, branching, seed):
        return table if (vocab, branching, seed) == tuple(table_key) else draw(vocab, branching,
                                                                               seed)

    data_lm._successors = successors
    out = {}
    for label, modelclass, kwargs in runs:
        kwargs = dict(kwargs)
        devices = kwargs.pop("devices", n)
        cuda = device.type == "cuda"  # (the harness's own check runs ranks on the CPU)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()  # each run's summary counts its own launches
        if devices == n or rank == 0:
            if rank == 0:
                print(f"[sp rank 0] {time.strftime('%H:%M:%S')} run {label}", flush=True)
            t0 = time.perf_counter()
            s = run_training("bsp", resolve_model("transformer_lm", modelclass), devices,
                             device=device, **kwargs)
            out[label] = {"summary": s, "wall_s": time.perf_counter() - t0,
                          "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None}
        if devices != n:
            dist.barrier()
    for label, sp, attn in profiles:
        out[label] = sp_profile(rank, n, device, sp, attn, SP_PROFILE_STEPS)
    return out


def _sp_launches_want(attn: str, sp: int, layers: int, steps: int, val_batches: int,
                      codec: bool, remat: bool = False, tp: int = 1, dp: int = 1) -> dict:
    """One rank's flash and codec launches of an ND run: the ring folds sp
    hops a layer (forward, dq and dk/dv each), Ulysses one local step;
    under remat the train step runs the forward twice; the codec one
    quantize and one dequantize launch a step for each exchange with a
    wire: the replicated leaves' over every rank, and under --tp the
    sharded leaves' over the data and seq ranks of their model index
    where those are more than one."""
    hops = sp if attn == "ring_flash" else 1
    rounds = 1 + (tp > 1 and dp * sp > 1) if codec else 0
    want = {name: 0 for name in LM_PARITY_FLASH}
    want.update(flash_fwd_sm90=hops * layers * ((2 if remat else 1) * steps + val_batches),
                flash_dq_sm90=hops * layers * steps, flash_dkv_sm90=hops * layers * steps,
                quant_block=rounds * steps, dequant_block=rounds * steps)
    return want


def _check_sp_run(label: str, s: dict, want: dict, steps: int) -> None:
    """The run reached step ``steps``, every loss it ran finite, the ranks'
    losses equal, the ranks of one model index holding equal replicas and
    every rank the same replicated leaves, and each rank launched
    ``want``."""
    losses = s["losses"]
    ran = steps - (s["resumed_from_step"] or 0)
    check(s["steps"] == steps and len(losses) == ran and s["nonfinite_steps"] == 0
          and all(math.isfinite(x) for x in losses),
          f"{label}: steps {s['steps']}, losses {losses}")
    check("val" in s and all(math.isfinite(v) for v in s["val"].values()),
          f"{label}: bad val metrics {s.get('val')}")
    finals = s["final_loss_per_rank"]
    check(len(set(finals)) == 1, f"{label}: the ranks' losses differ: {finals}")
    by_t: dict = {}
    for t, d in zip(s["tp_index_per_rank"], s["replica_digest_per_rank"]):
        by_t.setdefault(t, set()).add(d)
    check(all(len(d) == 1 for d in by_t.values()),
          f"{label}: the replicas of one model index differ: {s['replica_digest_per_rank']}")
    check(len(set(s["replicated_digest_per_rank"])) == 1,
          f"{label}: the replicated leaves differ: {s['replicated_digest_per_rank']}")
    for r, counts in enumerate(s["kernel_launches_per_rank"]):
        got = {k: counts.get(k, 0) for k in want}
        check(got == want, f"{label}: rank {r} launched {got}, expected {want}")
        stray = {k: v for k, v in counts.items() if k not in want and v}
        check(not stray, f"{label}: rank {r} launched other kernels: {stray}")


SP_RUNS = [("ring_flash", "TransformerLM_136M",
            sp_run_kwargs("ring_flash", SP_STEPS, SP_LAYERS, sp=2)),
           ("ulysses_flash+int8:ef", "TransformerLM_136M",
            sp_run_kwargs("ulysses_flash", SP_STEPS, SP_LAYERS, sp=2, wire_codec="int8:ef"))]


def spawn_nd_ranks(table_key, table) -> list:
    """Phase sp's and phase tp's runs in one spawn of 2 gloo ranks on
    cuda:0 (one start of the ranks for both); each rank's results."""
    import torch

    from theanompi_tpu_torch.launch.session import spawn_ranks

    runs = SP_RUNS + TP_RUNS
    print(f"[sp/tp] 2 gloo ranks on cuda:0, TransformerLM_136M at {SP_LAYERS} layers: "
          f"{[r[0] for r in runs]}", flush=True)
    torch.cuda.empty_cache()
    return spawn_ranks(sp_rank, 2, (table_key, table, runs), device="cuda:0", backend="gloo",
                       timeout=900)


def phase_sp(ranks):
    """The sequence-parallel LM on one card (module docstring, phase sp):
    the 136M width at 2 layers, 2 gloo ranks on cuda:0 at --sp 2, under
    ring_flash and under ulysses_flash with the int8:ef codec
    (``spawn_nd_ranks``); then one rank (attn flash) for the first step's
    loss."""
    import torch

    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.models.lm import TransformerLM_136M

    out = {}
    for label, _, kw in SP_RUNS:
        s = ranks[0][label]["summary"]
        attn = kw["recipe_overrides"]["attn"]
        want = _sp_launches_want(attn, 2, SP_LAYERS, SP_STEPS, 1, "wire_codec" in kw)
        _check_sp_run(f"sp {label}", s, want, SP_STEPS)
        out[label] = {"summary": s, "launches": want,
                      "peak_bytes_per_rank": [r[label]["peak_bytes"] for r in ranks]}
        print(f"[sp] {label}: losses {s['losses']}; val {s['val']}; step_ms per rank "
              f"{s['step_ms_per_rank']}; launches per rank {want} (as expected); replicas "
              f"equal", flush=True)
    torch.cuda.empty_cache()
    one = run_training("bsp", TransformerLM_136M, 1, device="cuda:0",
                       **sp_run_kwargs("flash", 1, SP_LAYERS))
    for label in out:
        a, b = out[label]["summary"]["losses"][0], one["losses"][0]
        check(abs(a - b) <= SP_LOSS_RTOL * abs(b),
              f"sp {label}: first loss {a} against one rank's {b} (rtol {SP_LOSS_RTOL})")
        out[label]["one_rank_first_loss"] = b
    print(f"[sp] first-step losses {[out[k]['summary']['losses'][0] for k in out]} against one "
          f"rank's {one['losses'][0]} (attn flash; rtol {SP_LOSS_RTOL})", flush=True)
    return out


def phase_sp4(table_key, table, n_cards: int) -> dict:
    """``--only sp``: the full-depth 136M over NCCL on 4 cards (module
    docstring, phase sp)."""
    import torch

    from theanompi_tpu_torch.launch.session import spawn_ranks

    check(n_cards >= 4, f"--only sp needs 4 cards, {n_cards} visible")
    ckpt = tempfile.mkdtemp(prefix="tmpi-sp-")
    long_kw = dict(recipe={"input_shape": (SP_LONG_T,), "batch_size": SP_LONG_BATCH})
    runs = []
    for attn, sp in (("ring_flash", 4), ("ulysses_flash", 4), ("ring_flash", 2)):
        mesh = f"sp{sp}" if sp == 4 else "dp2xsp2"
        runs.append((f"{attn} {mesh} eager", "TransformerLM_136M",
                     sp_run_kwargs(attn, SP4_STEPS, sp=sp)))
        runs.append((f"{attn} {mesh} captured", "TransformerLM_136M",
                     sp_run_kwargs(attn, SP4_STEPS, sp=sp, steps_per_dispatch=SP4_K)))
    runs += [
        # the eager run's epoch, cut halfway and resumed
        ("ring_flash sp4 cut", "TransformerLM_136M",
         sp_run_kwargs("ring_flash", SP4_STEPS // 2, sp=4, epoch_steps=SP4_STEPS, ckpt_dir=ckpt,
                       async_checkpoint=False)),
        ("ring_flash sp4 resumed", "TransformerLM_136M",
         sp_run_kwargs("ring_flash", SP4_STEPS, sp=4, ckpt_dir=ckpt, async_checkpoint=False,
                       resume=True)),
        ("350M ring_flash sp4", "TransformerLM_350M",
         sp_run_kwargs("ring_flash", SP350_STEPS, sp=4)),
        (f"T {SP_LONG_T} ring_flash sp4", "TransformerLM_136M",
         sp_run_kwargs("ring_flash", SP_LONG_STEPS, sp=4, **long_kw)),
        (f"T {SP_LONG_T} flash one card", "TransformerLM_136M",
         sp_run_kwargs("flash", SP_LONG_STEPS, devices=1, **long_kw)),
    ]
    profiles = [("profile ring_flash sp4", 4, "ring_flash"),
                ("profile ulysses_flash sp4", 4, "ulysses_flash")]
    print(f"[sp4] 4 NCCL ranks: {[r[0] for r in runs]}; profiles {[p[0] for p in profiles]}",
          flush=True)
    try:
        ranks = spawn_ranks(sp_rank, 4, (table_key, table, runs, profiles), timeout=900)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    r0 = ranks[0]
    out = {"runs": {}, "profiles": {p[0]: r0.get(p[0]) for p in profiles}}
    for label, modelclass, kw in runs:
        s = r0[label]["summary"]
        attn, sp = kw["recipe_overrides"]["attn"], kw.get("sp", 1)
        steps = kw["max_steps"] - (s["resumed_from_step"] or 0)
        layers = 24 if modelclass == "TransformerLM_350M" else LM_LAYERS
        T = kw["recipe_overrides"].get("input_shape", (1024,))[0]
        batch = kw["recipe_overrides"].get("batch_size", 8)
        if kw.get("devices") != 1:
            want = _sp_launches_want(attn, sp, layers, steps, 1, False,
                                     remat=modelclass == "TransformerLM_350M")
            _check_sp_run(f"sp4 {label}", s, want, kw["max_steps"])
        peaks = [r[label]["peak_bytes"] for r in ranks if label in r]
        row = {"step_ms": s["step_ms"], "steady_steps": s["steady_steps"],
               "window_s": s["step_ms"] * s["steady_steps"] / 1e3 if s["step_ms"] else None,
               "tokens_per_sec": batch * T / (s["step_ms"] / 1e3) if s["step_ms"] else None,
               "step_ms_per_rank": s["step_ms_per_rank"], "losses": s["losses"],
               "peak_bytes_per_card": peaks, "digest": s["replica_digest_per_rank"][0],
               "captured": s["captured"], "wall_s": r0[label]["wall_s"]}
        out["runs"][label] = row
        print(f"[sp4] {label}: step {row['step_ms']} ms over {row['steady_steps']} steady steps "
              f"({row['window_s']} s), {row['tokens_per_sec']} tokens/s, peak "
              f"{[round(p / 2**30, 3) for p in peaks if p]} GiB a card, losses {s['losses']}",
              flush=True)
    for mesh in ("ring_flash sp4", "ulysses_flash sp4", "ring_flash dp2xsp2"):
        e, c = out["runs"][f"{mesh} eager"], out["runs"][f"{mesh} captured"]
        check(c["captured"], f"sp4 {mesh}: the captured run replayed no graph")
        check(e["digest"] == c["digest"] and e["losses"] == c["losses"],
              f"sp4 {mesh}: eager and captured runs differ ({e['digest']} / {c['digest']})")
    e, res = out["runs"]["ring_flash sp4 eager"], r0["ring_flash sp4 resumed"]["summary"]
    check(res["resumed_from_step"] == SP4_STEPS // 2 and
          res["replica_digest_per_rank"][0] == e["digest"],
          f"sp4 resume: from step {res['resumed_from_step']}, digest "
          f"{res['replica_digest_per_rank'][0]} against {e['digest']}")
    print("[sp4] eager = captured bit for bit at every mesh; the resume ends on the "
          "uninterrupted run's state", flush=True)
    for label, p in out["profiles"].items():
        print(f"[sp4] {label}: {p}", flush=True)
    return out


# phase tp: the 136M width at 2 layers on one card (2 gloo ranks, --tp 2);
# --only tp on 4 cards over NCCL at full depth
TP_LAYERS = SP_LAYERS  # phase sp's one-rank run is phase tp's yardstick too
TP_STEPS = 3
TP4_STEPS = 32  # 30 steady steps, as --only sp
TP4_K = 4
TP350_STEPS = 4
# the first loss, --tp 2 against one rank: each block's two bf16 deltas
# summed over the model axis (a rounding more a sum) and the cross-entropy
# over the vocabulary's shards, on ~ln V
TP_LOSS_RTOL = 1e-3
TP_RUNS = [("tp2", "TransformerLM_136M", sp_run_kwargs("flash", TP_STEPS, TP_LAYERS, tp=2)),
           ("tp2+int8:ef", "TransformerLM_136M",
            sp_run_kwargs("flash", TP_STEPS, TP_LAYERS, tp=2, wire_codec="int8:ef"))]
TP4_MESHES = (("tp4", 4, 1, "flash"), ("dp2xtp2", 2, 1, "flash"),
              ("tp2xsp2 ring_flash", 2, 2, "ring_flash"),
              ("tp2xsp2 ulysses_flash", 2, 2, "ulysses_flash"))


def phase_tp(ranks, one_rank_first_loss: float) -> dict:
    """The tensor-parallel LM on one card (module docstring, phase tp):
    the runs of ``TP_RUNS`` from ``spawn_nd_ranks``, checked."""
    out = {}
    for label, _, kw in TP_RUNS:
        s = ranks[0][label]["summary"]
        codec = "wire_codec" in kw
        want = _sp_launches_want("flash", 1, TP_LAYERS, TP_STEPS, 1, codec, tp=2)
        _check_sp_run(f"tp {label}", s, want, TP_STEPS)
        check(s["tp"] == 2 and s["tp_index_per_rank"] == [0, 1]
              and s["mesh"] == {"shape": [1, 2], "axes": ["data", "model"]},
              f"tp {label}: mesh {s['mesh']}, tp indices {s['tp_index_per_rank']}")
        if codec:
            # the replicated leaves crossed the model axis through the
            # quantizer; the tp-sharded ones have no wire at --tp 2
            check(all(x > 0 for x in s["ef_norm_per_rank"])
                  and all(x == 0 for x in s["ef_unwired_norm_per_rank"]),
                  f"tp {label}: residual norms {s['ef_norm_per_rank']}, of the leaves with "
                  f"no wire {s['ef_unwired_norm_per_rank']}")
        a = s["losses"][0]
        check(abs(a - one_rank_first_loss) <= TP_LOSS_RTOL * abs(one_rank_first_loss),
              f"tp {label}: first loss {a} against one rank's {one_rank_first_loss} "
              f"(rtol {TP_LOSS_RTOL})")
        out[label] = {"summary": s, "launches": want, "one_rank_first_loss": one_rank_first_loss,
                      "peak_bytes_per_rank": [r[label]["peak_bytes"] for r in ranks]}
        print(f"[tp] {label}: losses {s['losses']} (first against one rank's "
              f"{one_rank_first_loss}, rtol {TP_LOSS_RTOL}); val {s['val']}; step_ms per rank "
              f"{s['step_ms_per_rank']}; launches per rank {want} (as expected); residual norms "
              f"{s['ef_norm_per_rank']}, of the unwired leaves {s['ef_unwired_norm_per_rank']}",
              flush=True)
    return out


def tp_reshard_check(rank, n, device, path: str, tp: int, modelclass: str,
                     overrides: dict) -> dict:
    """The --tp 2 file at ``path`` restored onto the ``--tp tp`` mesh of
    ``modelclass`` (its recipe with ``overrides``) under int8:ef through
    ``load_resharded`` and the engine's restore, gathered back: on rank 0
    the entries of params and optimizer state that are not the file's bit
    for bit, and the residual stacks that are not zero (both empty when
    the reshard is exact)."""
    import numpy as np
    import torch

    from theanompi_tpu_torch import bridge
    from theanompi_tpu_torch.launch.session import resolve_model
    from theanompi_tpu_torch.parallel.nd import NDEngine
    from theanompi_tpu_torch.utils.checkpoint import load_checkpoint, load_resharded, to_numpy

    cls = resolve_model("transformer_lm", modelclass)
    model = cls(cls.default_recipe().replace(**overrides))
    eng = NDEngine(model, n, device, tp=tp, wire_codec="int8:ef")
    init = eng.init_state(torch.Generator().manual_seed(0))
    layouts = model.param_layouts(init.params)
    t0 = time.perf_counter()
    flat, info = load_resharded(path, bridge.entry_shapes(eng.checkpoint_parts(init, layouts)),
                                eng.mesh_topology())
    state = eng.restore(flat, init, layouts)
    del flat
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    entries = eng.state_entries(state, layouts)
    if entries is None:
        return {}
    saved = load_checkpoint(path)
    unequal = [k for k, v in entries.items() if not k.startswith((".ef/", "__"))
               and not np.array_equal(to_numpy(v), saved[k])]
    ef_nonzero = [k for k, v in entries.items() if k.startswith(".ef/") and np.any(to_numpy(v))]
    return {"resharded": info["resharded"], "from_mesh": info["from_mesh"],
            "reset": len(info["reset"]), "entries": len(entries), "unequal": unequal,
            "ef_nonzero": ef_nonzero, "load_s": load_s}


def tp_rank(rank, n, device, table_key, table, runs, reshards=()):
    """One rank of ``--only tp``: ``sp_rank``'s runs, then each reshard
    check ``(label, path, tp, modelclass, recipe overrides)``
    (``tp_reshard_check``)."""
    out = sp_rank(rank, n, device, table_key, table, runs)
    for label, *check_args in reshards:
        out[label] = tp_reshard_check(rank, n, device, *check_args)
    return out


def phase_tp4(table_key, table, n_cards: int) -> dict:
    """``--only tp``: the full-depth 136M and the 350M over NCCL on 4
    cards (module docstring, phase tp)."""
    from theanompi_tpu_torch.launch.session import spawn_ranks

    check(n_cards >= 4, f"--only tp needs 4 cards, {n_cards} visible")
    ckpt, ckpt_tp2 = tempfile.mkdtemp(prefix="tmpi-tp-"), tempfile.mkdtemp(prefix="tmpi-tp2-")
    runs = []
    for mesh, tp, sp, attn in TP4_MESHES:
        runs.append((f"{mesh} eager", "TransformerLM_136M",
                     sp_run_kwargs(attn, TP4_STEPS, tp=tp, sp=sp)))
        runs.append((f"{mesh} captured", "TransformerLM_136M",
                     sp_run_kwargs(attn, TP4_STEPS, tp=tp, sp=sp, steps_per_dispatch=TP4_K)))
    codec = dict(wire_codec="int8:ef", ckpt_dir=ckpt_tp2, async_checkpoint=False)
    runs += [
        # the eager run's epoch, cut halfway and resumed
        ("tp4 cut", "TransformerLM_136M",
         sp_run_kwargs("flash", TP4_STEPS // 2, tp=4, epoch_steps=TP4_STEPS, ckpt_dir=ckpt,
                       async_checkpoint=False)),
        ("tp4 resumed", "TransformerLM_136M",
         sp_run_kwargs("flash", TP4_STEPS, tp=4, ckpt_dir=ckpt, async_checkpoint=False,
                       resume=True)),
        # a --tp 2 file (data 2 x tp 2) at step 4 of a 6-step epoch, then
        # resumed elastic at --tp 4 to the epoch's end
        ("tp2 int8:ef", "TransformerLM_136M",
         sp_run_kwargs("flash", 4, tp=2, epoch_steps=6, **codec)),
        ("tp4 int8:ef elastic", "TransformerLM_136M",
         sp_run_kwargs("flash", 6, tp=4, resume=True, elastic=True, **codec)),
        ("350M tp4", "TransformerLM_350M",
         sp_run_kwargs("flash", TP350_STEPS, tp=4, recipe={"loss_chunk": None})),
    ]
    reshards = [("tp2 file onto tp4", os.path.join(ckpt_tp2, "ckpt_4.npz"), 4,
                 "TransformerLM_136M", runs[-2][2]["recipe_overrides"])]
    print(f"[tp4] 4 NCCL ranks: {[r[0] for r in runs]}; reshards {[r[0] for r in reshards]}",
          flush=True)
    try:
        ranks = spawn_ranks(tp_rank, 4, (table_key, table, runs, reshards), timeout=1500)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(ckpt_tp2, ignore_errors=True)
    r0 = ranks[0]
    out = {"runs": {}, "reshards": {r[0]: r0[r[0]] for r in reshards}}
    for label, modelclass, kw in runs:
        s = r0[label]["summary"]
        attn, sp, tp = kw["recipe_overrides"]["attn"], kw.get("sp", 1), kw.get("tp", 1)
        steps = kw["max_steps"] - (s["resumed_from_step"] or 0)
        big = modelclass == "TransformerLM_350M"
        want = _sp_launches_want(attn, sp, 24 if big else LM_LAYERS, steps, 1,
                                 "wire_codec" in kw, remat=big, tp=tp, dp=4 // (tp * sp))
        _check_sp_run(f"tp4 {label}", s, want, kw["max_steps"])
        check(s["tp"] == tp and s["sp"] == sp, f"tp4 {label}: tp {s['tp']}, sp {s['sp']}")
        peaks = [r[label]["peak_bytes"] for r in ranks]
        row = {"step_ms": s["step_ms"], "steady_steps": s["steady_steps"],
               "tokens_per_sec": 8 * 1024 / (s["step_ms"] / 1e3) if s["step_ms"] else None,
               "step_ms_per_rank": s["step_ms_per_rank"], "losses": s["losses"],
               "peak_gib_per_card": [round(p / 2**30, 3) for p in peaks if p],
               "digests": s["replica_digest_per_rank"], "captured": s["captured"],
               "launches": want, "wall_s": r0[label]["wall_s"]}
        out["runs"][label] = row
        print(f"[tp4] {label}: step {row['step_ms']} ms over {row['steady_steps']} steady steps, "
              f"{row['tokens_per_sec']} tokens/s, peak {row['peak_gib_per_card']} GiB a card, "
              f"losses {s['losses'][0]} ... {s['losses'][-1]}, launches a rank "
              f"{ {k: v for k, v in want.items() if v} }", flush=True)
    for mesh, *_ in TP4_MESHES:
        e, c = out["runs"][f"{mesh} eager"], out["runs"][f"{mesh} captured"]
        check(c["captured"], f"tp4 {mesh}: the captured run replayed no graph")
        check(e["digests"] == c["digests"] and e["losses"] == c["losses"],
              f"tp4 {mesh}: eager and captured runs differ ({e['digests']} / {c['digests']})")
    e, res = out["runs"]["tp4 eager"], r0["tp4 resumed"]["summary"]
    check(res["resumed_from_step"] == TP4_STEPS // 2 and res["replica_digest_per_rank"] ==
          e["digests"], f"tp4 resume: from step {res['resumed_from_step']}, digests "
          f"{res['replica_digest_per_rank']} against {e['digests']}")
    el = r0["tp4 int8:ef elastic"]["summary"]
    check(el["resumed_from_step"] == 4 and el["reshard"]["resharded"]
          and el["reshard"]["from_mesh"] == {"shape": [2, 2], "axes": ["data", "model"]}
          and el["mesh"] == {"shape": [1, 4], "axes": ["data", "model"]},
          f"tp4 elastic: from step {el['resumed_from_step']}, reshard {el.get('reshard')}")
    for label, r in out["reshards"].items():
        check(r["resharded"] and not r["unequal"] and not r["ef_nonzero"] and r["reset"],
              f"tp4 {label}: {r}")
    print("[tp4] eager = captured bit for bit at every mesh; the resume ends on the "
          "uninterrupted run's state; the --tp 2 file restores onto --tp 4 with params and Adam's "
          f"state bit for bit and zero residuals: {out['reshards']}", flush=True)
    return out


def phase_remat_parity(dev):
    """A 2-layer bf16 LM with heads of 64 (the sm90 flash kernels) trained
    2 steps on the card with remat and without, and on the CPU with remat,
    from the same weights and batches: remat against no remat and against
    the CPU at phase lm-parity's bf16 limits (losses rtol 2e-2, the
    parameter change within 0.1 in relative norm), every leaf changed;
    remat launches flash_fwd_sm90 twice a layer a step. Then the 350M
    class at 2 layers through the CLI, eager against
    ``--steps-per-dispatch 2`` (its remat step captured in a CUDA graph):
    losses, validation and replica digest bit for bit."""
    import torch
    from theanompi_tpu_torch.models.lm import TransformerLMModel

    base = TransformerLMModel.default_recipe().replace(
        input_shape=(256,), num_classes=512, d_model=128, n_heads=2, n_layers=2, d_ff=512,
        batch_size=4, attn="flash", compute_dtype=torch.bfloat16)
    runs = {remat: _lm_two_steps(base.replace(remat=remat), dev) for remat in (True, False)}
    (lc, bc, pc, kc), (lr, br, pr, kr) = runs[True]["cpu"], runs[True][str(dev)]
    _, _, pn, kn = runs[False][str(dev)]
    check(not any(kc.values()), f"the CPU run launched kernels: {kc}")
    sm90 = ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90")
    for label, k, fwd in (("remat", kr, 8), ("no remat", kn, 4)):
        want = {n: 0 for n in LM_PARITY_FLASH}
        want.update(flash_fwd_sm90=fwd, flash_dq_sm90=4, flash_dkv_sm90=4)
        check({n: k[n] for n in LM_PARITY_FLASH} == want,
              f"remat-parity ({label}): the card run launched {k}, expected {want}")
    ln = runs[False][str(dev)][0]
    check(all(math.isfinite(x) for x in lr) and
          all(math.isclose(a, b, rel_tol=2e-2) for a, b in zip(lc, lr)) and
          all(math.isclose(a, b, rel_tol=2e-2) for a, b in zip(ln, lr)),
          f"remat-parity: card remat losses {lr}, no remat {ln}, CPU remat {lc} (rtol 2e-2)")
    d_rem = torch.cat([(b - b0).flatten() for b, b0 in zip(pr, br)])
    rels = {}
    for label, ref in (("cpu", pc), ("no_remat", pn)):
        d_ref = torch.cat([(a - b0).flatten() for a, b0 in zip(ref, br)])
        rels[label] = ((d_rem - d_ref).norm() / d_ref.norm()).item()
        check(rels[label] <= 0.1, f"remat-parity: the card's remat parameter change is "
                                  f"{rels[label]:.3g} of the {label} run's away from it (> 0.1)")
    for i, (b0, b) in enumerate(zip(br, pr)):
        check(bool(torch.isfinite(b).all()) and bool((b != b0).any()),
              f"remat-parity: leaf {i} did not change on the card, or is not finite")
    identical = lr == ln and all(torch.equal(a, b) for a, b in zip(pr, pn))
    print(f"[remat-parity] bf16 D 64: losses card remat {lr}, no remat {ln}, CPU remat {lc}; "
          f"parameter change from the CPU's {rels['cpu']:.4g}, from no remat's "
          f"{rels['no_remat']:.4g} (relative norm); remat = no remat bit for bit: {identical}; "
          f"launches remat { {n: kr[n] for n in sm90} }, no remat { {n: kn[n] for n in sm90} }",
          flush=True)
    tiny = ["--recipe-arg", "d_model=128", "--recipe-arg", "n_heads=2", "--recipe-arg",
            "n_layers=2", "--recipe-arg", "d_ff=512", "--recipe-arg", "input_shape=[256]",
            "--recipe-arg", "num_classes=512"]
    argv = ["BSP", "1", "transformer_lm", "TransformerLM_350M", "--synthetic", "--max-steps",
            "6", "--print-freq", "1", "--seed", "0", "--dataset-arg", "n_train=48",
            "--dataset-arg", "n_val=8", *tiny]
    eager = run_cli(argv)
    captured = run_cli([*argv, "--steps-per-dispatch", "2"])
    check(captured["captured"] and captured["graph"]["captures"] == 1,
          f"remat-parity: the grouped remat run did not replay a graph: {captured['graph']}")
    for key in ("losses", "val", "replica_digest_per_rank"):
        check(eager[key] == captured[key], f"remat-parity: eager and captured remat runs differ "
                                           f"in {key}: {eager[key]} vs {captured[key]}")
    print(f"[remat-parity] 350M class at 2 layers through the CLI: eager = captured bit for "
          f"bit (graph {captured['graph']}, losses {captured['losses']})", flush=True)
    return {"launches": {"remat": {n: kr[n] for n in sm90}, "no_remat": {n: kn[n] for n in sm90}},
            "rel_change_vs_cpu": rels["cpu"], "rel_change_vs_no_remat": rels["no_remat"],
            "bit_identical_to_no_remat": identical, "graph": captured["graph"]}


E2E_DEPTHS = (1, 2)


def phase_e2e():
    """``tools/bench.py --mode e2e`` at full width: AlexNet (227 crop,
    batch 128, ``--fused-update``) from its own 256x256 uint8 shards
    through ``run_training``, 48 steps at dispatch depths 1 and 2, then
    the recovery pair (a clean checkpointed run, a crashed one resumed by
    the supervisor). Each run: its steps all executed, one fused_momentum
    launch a step and no other kernel, a native gather a step; exactly one
    retry."""
    from theanompi_tpu_torch.tools.bench import bench_e2e

    t0 = time.perf_counter()
    r = bench_e2e(dispatch_depths=E2E_DEPTHS, recovery=True)
    for row in r["dispatch_sweep"]:
        launches = {k: v for k, v in row["kernel_launches"].items() if v}
        check(row["steps"] == row["device_steps"] == r["max_steps"],
              f"e2e depth {row['dispatch_depth']}: {row['device_steps']} of {row['steps']}")
        check(launches == {"fused_momentum": r["max_steps"]},
              f"e2e depth {row['dispatch_depth']}: launches {launches}, expected one "
              "fused_momentum a step and nothing else")
        check(row["native_calls"].get("tmpi_gather_rows", 0) >= r["max_steps"]
              and row["native_calls"].get("tmpi_crop_mirror_u8", 0) >= r["max_steps"],
              f"e2e depth {row['dispatch_depth']}: native calls {row['native_calls']}")
    check(r["recovery_retries"] == 1, f"e2e recovery: {r['recovery_retries']} retries")
    print(f"[e2e] {time.perf_counter() - t0:.1f} s; " + json.dumps(r), flush=True)
    return r


# steps a trial of the scaling probe: at 6-11 ms a step a trial lasts
# 0.6-1.1 s, long enough that the trials' spread is not the reading
SCALING_STEPS = 96


def phase_scaling(n_cards: int):
    """``tools/bench.py --mode scaling``: the fixed-work probe (Cifar10 at
    a total batch of 512) over 1 and 2 ranks (one card: the 2 ranks share
    it over gloo), and on 4 cards over NCCL at 1, 2 and 4 ranks with
    flat psum against hier over 2 slices at 4; every probe's replicas
    identical (checked in the tool)."""
    from theanompi_tpu_torch.tools.bench import bench_scaling

    ns = (1, 2, 4) if n_cards >= 4 else (1, 2)
    t0 = time.perf_counter()
    r = bench_scaling(ns, steps=SCALING_STEPS, batch=512)
    check([x["n_devices"] for x in r["table"]] == list(ns), f"scaling rows {r['table']}")
    check(len(r["hier"]) == (2 if n_cards >= 4 else 0), f"scaling hier rows {r['hier']}")
    for x in r["table"] + r["hier"]:
        check(len(set(x["replica_digest_per_rank"])) == 1 and all(
            math.isfinite(v) for v in x["losses"]), f"scaling row {x}")
        print(f"[scaling] n {x['n_devices']} ({x['backend']}, {x['strategy']}, "
              f"{x['slices']} slice(s)): {x['images_per_sec']:.1f} img/s, "
              f"{x['step_ms']:.3f} ms a step"
              + (f", efficiency {x['efficiency']:.4f}" if "efficiency" in x else ""), flush=True)
    print(f"[scaling] {time.perf_counter() - t0:.1f} s; " + json.dumps(r), flush=True)
    return r


def phase_flash_times(dev, mem_rate, fp32_peak, bf16_peak):
    """Each flash kernel at the 136M LM's attention shape (bf16, causal):
    per-launch time, its bound, the plain version, and the SDPA yardstick.
    The two forwards (the generic kernel's bf16 instantiation and
    flash_fwd_sm90) run in turns, old, new, new, old, and so do the two
    dq kernels and the two dk/dv kernels (flash_dq's and flash_dkv's bf16
    instantiations against flash_dq_sm90 and flash_dkv_sm90). Then at D 60
    (the same BH and T): the generic forward, dq and dk/dv each in turns
    with the mma.sync bf16 kernel that took its place there
    (flash_fwd_mma_bf16, flash_dq_mma_bf16, flash_dkv_mma_bf16), SDPA at D
    60 as the yardstick (keys ``*_d60`` for the generic kernels)."""
    import torch
    import torch.nn.functional as F
    from theanompi_tpu_torch.ops import flash_attention as fa

    B, T, H, D = LM_SHAPE["B"], LM_SHAPE["T"], LM_SHAPE["H"], LM_SHAPE["D"]
    BH = B * H
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v, do = (torch.randn(BH, T, D, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=True, scale=1.0 / math.sqrt(D))
    o, lse = fa.flash_fwd(q, k, v, **kw)
    dsum = torch.sum(do.float() * o.float(), dim=-1)
    pairs = BH * T * (T + 1) // 2  # the (query, key) pairs the causal mask keeps
    tile = 2 * BH * T * D  # bytes of one bf16 [BH, T, D] tensor
    rows = 4 * BH * T  # bytes of one f32 [BH, T] vector
    fkw = dict(kw, q_off=0, k_off=0)
    fwd_plain = lambda: fa.flash_fwd_plain(q, k, v, **kw)  # noqa: E731
    dq_plain = lambda: fa.flash_dq_plain(q, k, v, do, lse, dsum, **kw)  # noqa: E731
    dkv_plain = lambda: fa.flash_dkv_plain(q, k, v, do, lse, dsum, **kw)  # noqa: E731
    specs = {
        # name: (kernel, plain, bytes, bf16 FLOPs, fp32 FLOPs)
        "flash_fwd_sm90": (lambda: fa._launch_fwd_sm90(q, k, v, **fkw), fwd_plain,
                           4 * tile + rows, 4 * D * pairs, 0),
        # the generic kernel's bf16 instantiation, which the LM ran before
        "flash_fwd": (lambda: fa._launch_fwd_generic(q, k, v, **fkw), fwd_plain,
                      4 * tile + rows, 4 * D * pairs, 0),
        "flash_dq_sm90": (lambda: fa._launch_dq_sm90(q, k, v, do, lse, dsum, **fkw), dq_plain,
                          4 * tile + 2 * rows + 2 * tile, 6 * D * pairs, 0),
        # the generic kernel's bf16 instantiation, which the LM ran before
        # flash_dq_sm90
        "flash_dq": (lambda: fa._launch_dq_generic(q, k, v, do, lse, dsum, **fkw), dq_plain,
                     4 * tile + 2 * rows + 2 * tile, 6 * D * pairs, 0),
        # dv's fp32 x fp32 product as three exact bf16 products: 12 D a pair
        "flash_dkv_sm90": (lambda: fa._launch_dkv_sm90(q, k, v, do, lse, dsum, **fkw),
                           dkv_plain, 4 * tile + 2 * rows + 4 * tile, 12 * D * pairs, 0),
        # the generic kernel's bf16 instantiation (dv in fp32 FMAs), which
        # the LM ran before flash_dkv_sm90
        "flash_dkv": (lambda: fa._launch_dkv_generic(q, k, v, do, lse, dsum, **fkw), dkv_plain,
                      4 * tile + 2 * rows + 4 * tile, 6 * D * pairs, 2 * D * pairs),
    }
    # the yardstick: SDPA's causal forward, and its whole backward
    q4, k4, v4 = (t.view(B, H, T, D).detach().clone().requires_grad_(True) for t in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(B, H, T, D)
    with torch.no_grad():
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                           reps=20)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True),
                       reps=20)
    # the old and the new kernel of each pair in turns (old, new, new,
    # old): one mean each
    turns = {}
    for old, new in (("flash_fwd", "flash_fwd_sm90"), ("flash_dq", "flash_dq_sm90"),
                     ("flash_dkv", "flash_dkv_sm90")):
        turns[old], turns[new] = [], []
        for name in (old, new, new, old):
            turns[name].append(cuda_ms(specs[name][0], reps=20))
        print(f"[times] bf16 in turns (old, new, new, old): {old} {turns[old]} ms, {new} "
              f"{turns[new]} ms", flush=True)
    plain_ms_of = {}  # a pair shares its plain version: one function, one input, timed once
    results = {}

    def record(specs, lib_fwd, lib_bwd, label=""):
        for name, (kern, plain, byts, bf16_ops, fp32_ops) in specs.items():
            if name in turns:
                ms = sum(turns[name]) / len(turns[name])
            else:
                ms = cuda_ms(kern, reps=10)
            if plain not in plain_ms_of:
                plain_ms_of[plain] = cuda_ms(plain, reps=3, warmup=1)
            plain_ms = plain_ms_of[plain]
            bytes_ms = byts / mem_rate * 1e3
            ops_ms = (bf16_ops / bf16_peak + fp32_ops / fp32_peak) * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            lib = lib_fwd if name.startswith("flash_fwd") else lib_bwd
            results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bytes=byts,
                                 bf16_flop=bf16_ops, fp32_flop=fp32_ops, library_ms=lib,
                                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                                 turns_ms=turns.get(name))
            print(f"[times] {name}{label}: {ms:.4f} ms/launch | bound {bound_ms:.4f} ms "
                  f"({byts / 1e6:.1f} MB -> {bytes_ms * 1e3:.1f} us; {bf16_ops / 1e9:.2f} GFLOP "
                  f"bf16 + {fp32_ops / 1e9:.2f} GFLOP fp32 -> {ops_ms * 1e3:.1f} us; "
                  f"{results[name]['bound_by']}) | {bound_ms / ms * 100:.1f}% of bound | plain "
                  f"{plain_ms:.4f} ms | SDPA "
                  f"{'forward' if name.startswith('flash_fwd') else 'backward (dq, dk, dv)'} "
                  f"{lib:.4f} ms", flush=True)

    record(specs, sdpa_fwd, sdpa_bwd)
    del q4, k4, v4, out4

    # D 60: the bf16 heads the *_mma_bf16 kernels take (rows of no whole
    # 16-byte units), each in turns with the generic kernel it replaced
    D6 = 60
    q6, k6, v6, do6 = (torch.randn(BH, T, D6, generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(4))
    kw6 = dict(causal=True, scale=1.0 / math.sqrt(D6))
    fkw6 = dict(kw6, q_off=0, k_off=0)
    o6, lse6 = fa.flash_fwd(q6, k6, v6, **kw6)
    dsum6 = torch.sum(do6.float() * o6.float(), dim=-1)
    tile6 = 2 * BH * T * D6
    fwd6_plain = lambda: fa.flash_fwd_plain(q6, k6, v6, **kw6)  # noqa: E731
    dq6_plain = lambda: fa.flash_dq_plain(q6, k6, v6, do6, lse6, dsum6, **kw6)  # noqa: E731
    dkv6_plain = lambda: fa.flash_dkv_plain(q6, k6, v6, do6, lse6, dsum6, **kw6)  # noqa: E731
    specs6 = {
        "flash_fwd_mma_bf16": (lambda: fa._launch_fwd_mma_bf16(q6, k6, v6, **fkw6), fwd6_plain,
                               4 * tile6 + rows, 4 * D6 * pairs, 0),
        "flash_fwd_d60": (lambda: fa._launch_fwd_generic(q6, k6, v6, **fkw6), fwd6_plain,
                          4 * tile6 + rows, 4 * D6 * pairs, 0),
        "flash_dq_mma_bf16": (
            lambda: fa._launch_dq_mma_bf16(q6, k6, v6, do6, lse6, dsum6, **fkw6), dq6_plain,
            4 * tile6 + 2 * rows + 2 * tile6, 6 * D6 * pairs, 0),
        "flash_dq_d60": (lambda: fa._launch_dq_generic(q6, k6, v6, do6, lse6, dsum6, **fkw6),
                         dq6_plain, 4 * tile6 + 2 * rows + 2 * tile6, 6 * D6 * pairs, 0),
        # dv's fp32 x fp32 product as three exact bf16 products: 12 D a pair
        "flash_dkv_mma_bf16": (
            lambda: fa._launch_dkv_mma_bf16(q6, k6, v6, do6, lse6, dsum6, **fkw6), dkv6_plain,
            4 * tile6 + 2 * rows + 4 * tile6, 12 * D6 * pairs, 0),
        "flash_dkv_d60": (lambda: fa._launch_dkv_generic(q6, k6, v6, do6, lse6, dsum6, **fkw6),
                          dkv6_plain, 4 * tile6 + 2 * rows + 4 * tile6, 6 * D6 * pairs,
                          2 * D6 * pairs),
    }
    q4, k4, v4 = (t.view(B, H, T, D6).detach().clone().requires_grad_(True) for t in (q6, k6, v6))
    backend6 = sdpa_backend(q4, k4, v4)
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    with torch.no_grad():
        sdpa_fwd6 = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                            reps=20)
    sdpa_bwd6 = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do6.view(B, H, T, D6),
                                                    retain_graph=True), reps=20)
    for new in ("flash_fwd_mma_bf16", "flash_dq_mma_bf16", "flash_dkv_mma_bf16"):
        old = f"{new[:-9]}_d60"  # the generic kernel it replaced at D 60
        turns[old], turns[new] = [], []
        for name in (old, new, new, old):
            turns[name].append(cuda_ms(specs6[name][0], reps=20))
        print(f"[times] bf16 D 60 in turns (old, new, new, old): {new[:-9]} {turns[old]} ms, "
              f"{new} {turns[new]} ms", flush=True)
    print(f"[times] SDPA at D 60: backend {backend6}, forward {sdpa_fwd6:.4f} ms, backward "
          f"{sdpa_bwd6:.4f} ms", flush=True)
    record(specs6, sdpa_fwd6, sdpa_bwd6, label=" (bf16, D 60)")
    for name in specs6:
        results[name]["sdpa_backend"] = backend6
    del q4, k4, v4, out4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def sdpa_backend(q4, k4, v4) -> str:
    """The backend PyTorch's dispatcher picks for a causal SDPA call on
    these inputs (``torch._fused_sdp_choice``)."""
    import torch
    from torch.nn.attention import SDPBackend

    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(q4, k4, v4, None, 0.0, True)), "unknown")


def device_kernel_names(fn) -> list:
    """The device kernels one call of ``fn`` launches, by name, from
    torch.profiler; a one-item list saying why when the profiler sees no
    device activity or fails (a reading, not a check)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
    except Exception as e:  # the profiler is untried on this card's machine
        return [f"not measured: torch.profiler failed ({type(e).__name__}: {e})"]
    return names or ["not measured: the profiler saw no device kernel"]


def phase_flash_times_fp32(dev, mem_rate, fp32_peak, tf32_peak):
    """The fp32 flash kernels at the 136M LM's attention shape (BH 96, T
    1024, D 64, causal), random fp32 inputs: flash_fwd_mma (3xTF32 on
    mma.sync) against the generic kernel's fp32 instantiation (fp32 FMAs,
    through ``fa._launch_fwd_generic``) in turns, old, new, new, old;
    flash_dq_mma and flash_dkv_mma (3xTF32 on mma.sync) against the
    generic flash_dq's and flash_dkv's fp32 instantiations the same way;
    SDPA's fp32 forward and backward as the yardstick,
    with the backend PyTorch's dispatcher picks, the device kernels its
    forward launches, and each forward's largest error against a float64
    forward of the same inputs (a single tf32 product would leave about
    1e-3). Bounds: bytes over the memory rate against the products, fp32
    FMAs at the fp32 peak, the three tf32 products of each product of
    flash_fwd_mma, flash_dq_mma and flash_dkv_mma at the tf32 tensor-core
    peak."""
    import torch
    import torch.nn.functional as F
    from theanompi_tpu_torch.ops import flash_attention as fa

    B, T, H, D = LM_SHAPE["B"], LM_SHAPE["T"], LM_SHAPE["H"], LM_SHAPE["D"]
    BH = B * H
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v, do = (torch.randn(BH, T, D, generator=g, device=dev) for _ in range(4))
    kw = dict(causal=True, scale=1.0 / math.sqrt(D))
    fkw = dict(kw, q_off=0, k_off=0)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    dsum = torch.sum(do * o, dim=-1)
    pairs = BH * T * (T + 1) // 2
    tile = 4 * BH * T * D  # bytes of one fp32 [BH, T, D] tensor
    rows = 4 * BH * T
    fwd_plain = lambda: fa.flash_fwd_plain(q, k, v, **kw)  # noqa: E731
    dkv_plain = lambda: fa.flash_dkv_plain(q, k, v, do, lse, dsum, **kw)  # noqa: E731
    dq_plain = lambda: fa.flash_dq_plain(q, k, v, do, lse, dsum, **kw)  # noqa: E731
    specs = {
        # name: (kernel, plain, bytes, fp32 FLOPs, tf32 FLOPs)
        "flash_fwd_mma": (lambda: fa._launch_fwd_mma(q, k, v, **fkw), fwd_plain,
                          4 * tile + rows, 0, 3 * 4 * D * pairs),
        "flash_fwd_fp32": (lambda: fa._launch_fwd_generic(q, k, v, **fkw), fwd_plain,
                           4 * tile + rows, 4 * D * pairs, 0),
        "flash_dq_fp32": (lambda: fa._launch_dq_generic(q, k, v, do, lse, dsum, **fkw),
                          dq_plain, 5 * tile + 2 * rows, 6 * D * pairs, 0),
        # three products (S, dP, dQ), each as three tf32 products
        "flash_dq_mma": (lambda: fa._launch_dq_mma(q, k, v, do, lse, dsum, **fkw), dq_plain,
                         5 * tile + 2 * rows, 0, 3 * 6 * D * pairs),
        "flash_dkv_fp32": (lambda: fa._launch_dkv_generic(q, k, v, do, lse, dsum, **fkw),
                           dkv_plain, 6 * tile + 2 * rows, 8 * D * pairs, 0),
        # four products (S, dP, dV, dK), each as three tf32 products
        "flash_dkv_mma": (lambda: fa._launch_dkv_mma(q, k, v, do, lse, dsum, **fkw),
                          dkv_plain, 6 * tile + 2 * rows, 0, 3 * 8 * D * pairs),
    }
    q4, k4, v4 = (t.view(B, H, T, D).detach().clone().requires_grad_(True) for t in (q, k, v))
    backend = sdpa_backend(q4, k4, v4)
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    with torch.no_grad():
        sdpa_call = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)  # noqa: E731
        sdpa_fwd = cuda_ms(sdpa_call, reps=20)
        kernels = device_kernel_names(sdpa_call)
        # float64 forward of the same inputs: each forward's largest error
        s64 = torch.matmul(q.double(), k.double().transpose(1, 2)) * kw["scale"]
        s64.masked_fill_(~torch.ones(T, T, dtype=torch.bool, device=dev).tril(), -math.inf)
        o64 = torch.matmul(torch.softmax(s64, dim=-1), v.double())
        del s64
        f64_err = {name: (out.reshape(BH, T, D).double() - o64).abs().max().item() for name, out in (
            ("sdpa", sdpa_call()), ("flash_fwd_mma", fa._launch_fwd_mma(q, k, v, **fkw)[0]),
            ("flash_fwd_fp32", fa._launch_fwd_generic(q, k, v, **fkw)[0]),
            ("plain", fwd_plain()[0]))}
        del o64
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do.view(B, H, T, D),
                                                   retain_graph=True), reps=20)
    print(f"[times] fp32 SDPA at the 136M shape: backend {backend}; forward kernels {kernels}; "
          f"torch.backends.cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; "
          f"max |o - o_float64|: {f64_err}", flush=True)
    turns = {}
    for old, new in (("flash_fwd_fp32", "flash_fwd_mma"), ("flash_dq_fp32", "flash_dq_mma"),
                     ("flash_dkv_fp32", "flash_dkv_mma")):
        turns[old], turns[new] = [], []
        for name in (old, new, new, old):
            turns[name].append(cuda_ms(specs[name][0], reps=20))
        print(f"[times] fp32 in turns (old, new, new, old): {old[:-5]} {turns[old]} ms, {new} "
              f"{turns[new]} ms", flush=True)
    plain_ms_of = {}
    results = {}
    for name, (kern, plain, byts, fp32_ops, tf32_ops) in specs.items():
        ms = (sum(turns[name]) / len(turns[name]) if name in turns else cuda_ms(kern, reps=10))
        if plain not in plain_ms_of:
            plain_ms_of[plain] = cuda_ms(plain, reps=3, warmup=1)
        bytes_ms = byts / mem_rate * 1e3
        ops_ms = (fp32_ops / fp32_peak + tf32_ops / tf32_peak) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        lib = sdpa_fwd if name.startswith("flash_fwd") else sdpa_bwd
        results[name] = dict(ms=ms, plain_ms=plain_ms_of[plain], bound_ms=bound_ms, bytes=byts,
                             fp32_flop=fp32_ops, tf32_flop=tf32_ops, library_ms=lib,
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                             turns_ms=turns.get(name), sdpa_backend=backend,
                             sdpa_kernels=kernels, float64_max_abs_err=f64_err)
        print(f"[times] {name}: {ms:.4f} ms/launch | bound {bound_ms:.4f} ms ({byts / 1e6:.2f} MB "
              f"-> {bytes_ms * 1e3:.1f} us; {fp32_ops / 1e9:.2f} GFLOP fp32 + {tf32_ops / 1e9:.2f} "
              f"GFLOP tf32 -> {ops_ms * 1e3:.1f} us; {results[name]['bound_by']}) | "
              f"{bound_ms / ms * 100:.1f}% of bound | plain {plain_ms_of[plain]:.4f} ms | SDPA fp32 "
              f"{'forward' if name.startswith('flash_fwd') else 'backward (dq, dk, dv)'} "
              f"{lib:.4f} ms ({backend})", flush=True)
    del q4, k4, v4, out4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def inception_pool_shapes(batch: int = GNET_BATCH):
    """The nine inception pool branches' NHWC inputs at 224x224x3, in
    trunk order, from the model's own shape walk."""
    from theanompi_tpu_torch.models.googlenet import GoogLeNet, Inception

    model = GoogLeNet(GoogLeNet.default_recipe().replace(batch_size=batch), pool_kernel=True)
    blocks, _ = model.block_inputs()
    return [tuple(shape) for _, block, shape in blocks if isinstance(block, Inception)]


def pool_inputs(kind: str, shape, dtype, gen, dev):
    """``random``: normal values (rare ties in fp32, some in bf16);
    ``tie-heavy``: ReLU zeros and a few levels, as an inception pool's
    input has; ``nan-inf``: normal values with 2% NaN, 2% +inf, 2% -inf.
    No -0.0: the sign of a zero maximum over +0 and -0 is not pinned."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev)
    if kind == "tie-heavy":
        x = torch.clamp_min(torch.round(x * 2) / 2, 0.0) + 0.0
    elif kind == "nan-inf":
        u = torch.rand(shape, generator=gen, device=dev)
        x = torch.where(u < 0.02, float("nan"), x)
        x = torch.where((u >= 0.02) & (u < 0.04), float("inf"), x)
        x = torch.where((u >= 0.04) & (u < 0.06), -float("inf"), x)
    return x.to(dtype)


# shapes that cut the halo tile (ops/pool.py: tile_plan): a ragged band and
# width, the widest map ``routable`` admits (two column tiles), one pixel
POOL_TILE_EDGES = [(4, 29, 31, 72), (2, 64, 64, 64), (3, 1, 1, 8)]
# a 16-byte-aligned shape, run from views off the boundary (the VEC = 1 path)
POOL_MISALIGNED = (2, 14, 14, 64)


def off_by_one(t):
    """``t``'s values in a contiguous view whose base lies one element past
    a 16-byte boundary: a slice of a larger flat buffer."""
    buf = t.new_empty(t.numel() + 1)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    check(v.data_ptr() % 16 == t.element_size(), "the view is not one element off alignment")
    return v


def phase_pool(dev):
    """Kernels #12-13 against their plain versions, bit for bit, at the
    inception pools' shapes at batch 512, the reference tests' odd
    shapes, shapes that cut the halo tile and views off 16-byte
    alignment, then the tie-rule control."""
    import torch
    import torch.nn.functional as F
    from theanompi_tpu_torch.ops import pool as tp

    g = torch.Generator(device=dev).manual_seed(12)
    shapes = sorted(set(inception_pool_shapes()), key=lambda s: (-s[1], s[3]))
    shapes += [(2, 8, 8, 16), (3, 7, 5, 130)] + POOL_TILE_EDGES + [POOL_MISALIGNED]
    worst = {"maxpool3x3_fwd": 0.0, "maxpool3x3_bwd": 0.0}
    n = 0
    tp.MAXPOOL_FWD.reset()
    tp.MAXPOOL_BWD.reset()
    for i, shape in enumerate(shapes):
        # the last case: every tensor a view one element past a 16-byte boundary
        view = off_by_one if i == len(shapes) - 1 else (lambda t: t)
        for dt in (torch.float32, torch.bfloat16):
            for kind in ("random", "tie-heavy", "nan-inf"):
                x = view(pool_inputs(kind, shape, dt, g, dev))
                gy = view(torch.randn(shape, generator=g, device=dev).to(dt))
                py = tp.maxpool3x3_fwd_plain(x)
                y, pyv = tp.maxpool3x3_fwd(x), view(py)
                dx, pdx = tp.maxpool3x3_bwd(x, pyv, gy), tp.maxpool3x3_bwd_plain(x, py, gy)
                torch.cuda.synchronize()
                n += 1
                check(bits_equal(y, py), f"#12 forward differs from its plain version "
                                         f"({shape} {str(dt)[6:]} {kind})")
                check(bits_equal(dx, pdx), f"#13 backward differs from its plain version "
                                           f"({shape} {str(dt)[6:]} {kind})")
                for name, a, b in (("maxpool3x3_fwd", y, py), ("maxpool3x3_bwd", dx, pdx)):
                    fin = torch.isfinite(a.float()) & torch.isfinite(b.float())
                    worst[name] = max(worst[name], (a.float()[fin] - b.float()[fin]).abs().max().item()
                                      if fin.any() else 0.0)
                del x, gy, y, py, pyv, dx, pdx
        print(f"  {str(shape):20s} fp32 and bf16, random / tie-heavy / nan-inf"
              f"{' (views 1 element past 16-byte alignment)' if i == len(shapes) - 1 else ''}"
              ": forward and backward bit-identical", flush=True)
    got = (tp.MAXPOOL_FWD.launches, tp.MAXPOOL_BWD.launches)
    check(got == (n, n), f"pool counters moved {got}, expected ({n}, {n})")
    # the control: select-and-scatter's gradient (F.max_pool2d's backward,
    # first maximum) on tie-heavy input must fail the backward check
    shape = inception_pool_shapes()[0]
    readings = {}
    for dt in (torch.float32, torch.bfloat16):
        x = pool_inputs("tie-heavy", shape, dt, g, dev)
        gy = torch.randn(shape, generator=g, device=dev).to(dt)
        py = tp.maxpool3x3_fwd_plain(x)
        pdx = tp.maxpool3x3_bwd_plain(x, py, gy)
        xr = x.permute(0, 3, 1, 2).detach().requires_grad_(True)  # channels_last
        yr = F.max_pool2d(xr, 3, 1, 1)
        (sdx,) = torch.autograd.grad(yr, xr, gy.permute(0, 3, 1, 2))
        sdx = sdx.permute(0, 2, 3, 1).contiguous()
        check(bits_equal(yr.detach().permute(0, 2, 3, 1).contiguous(), py),
              "F.max_pool2d's forward is not the plain forward")
        differs = (sdx != pdx).float().mean().item()
        readings[str(dt)[6:]] = differs
        check(not bits_equal(sdx, pdx), "the select-and-scatter control passes the backward "
                                        "check: it cannot tell the tie rules apart")
        del x, gy, py, pdx, xr, yr, sdx
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[pool] control: F.max_pool2d's backward on tie-heavy {shape} differs from the "
          f"all-maxima backward in a share {readings} of the elements: refused", flush=True)
    return worst, n, readings


def _no_dropout(model):
    from theanompi_tpu_torch import nn as tnn

    for seq in (model.head, *model.aux.values()):
        for layer in seq.layers:
            if isinstance(layer, tnn.Dropout):
                layer.rate = 0.0
    return model


def googlenet_device_step_ms(pool_kernel: bool, steps: int = 5, warmup: int = 2) -> float:
    """One training step of full-width GoogLeNet at batch 512 with the
    batch already on the card (BSPEngine, --fused-update): CUDA events
    over ``steps`` steps after ``warmup``."""
    import torch
    from theanompi_tpu_torch.device import resolve_device
    from theanompi_tpu_torch.models.googlenet import GoogLeNet
    from theanompi_tpu_torch.parallel.bsp import BSPEngine

    dev = resolve_device(None)
    model = GoogLeNet(GoogLeNet.default_recipe().replace(batch_size=GNET_BATCH),
                      pool_kernel=pool_kernel)
    engine = BSPEngine(model, 1, dev, steps_per_epoch=10_000, fused_update=True)
    box = {"state": engine.init_state(torch.Generator().manual_seed(0))}
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(GNET_BATCH, 224, 224, 3, generator=gen, device=dev)
    y = torch.randint(0, 1000, (GNET_BATCH,), generator=gen, device=dev)

    def step():
        box["state"], _ = engine.train_step(box["state"], x, y, gen)

    ms = cuda_ms(step, reps=steps, warmup=warmup)
    del box, x, y, engine
    torch.cuda.empty_cache()
    return ms


def phase_googlenet_main():
    """Full-width GoogLeNet through the CLI with the pool kernel, then
    without it; counters zeroed just before each run and read just after.
    Then the device step of both, with the batch resident, in turns."""
    import torch
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    runs = {}
    for label, flag in (("pool-kernel", ["--pool-kernel"]), ("library-pool", [])):
        argv = ["BSP", "1", "googlenet", "GoogLeNet", "--synthetic", *flag, "--fused-update",
                "--batch-size", str(GNET_BATCH), "--max-steps", str(GNET_STEPS),
                "--print-freq", "1", "--seed", "0",
                "--dataset-arg", f"n_train={GNET_BATCH * GNET_STEPS}",
                "--dataset-arg", f"n_val={GNET_BATCH}"]
        print(f"[googlenet-main] python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        summary = run_cli(argv)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = summary["losses"]
        check(summary["steps"] == GNET_STEPS and len(losses) == GNET_STEPS
              and all(math.isfinite(v) for v in losses) and summary["nonfinite_steps"] == 0,
              f"googlenet {label} run: steps {summary['steps']}, losses {losses}")
        check("val" in summary and all(math.isfinite(v) for v in summary["val"].values()),
              f"googlenet {label} run: bad val metrics {summary.get('val')}")
        on = bool(flag)
        want = {"maxpool3x3_fwd": 9 * (GNET_STEPS + 1) if on else 0,
                "maxpool3x3_bwd": 9 * GNET_STEPS if on else 0,
                "fused_momentum": update_launches(128) * GNET_STEPS}
        got = {k: counts[k] for k in want}
        check(got == want, f"googlenet {label} run launched {got}, expected {want}")
        stray = {k: v for k, v in counts.items() if k not in want and v}
        check(not stray, f"the googlenet {label} run launched other kernels: {stray}")
        print(f"[googlenet-main] {label}: per-step loss {losses}; val {summary['val']}", flush=True)
        print(f"[googlenet-main] {label}: steady-state step {summary['step_ms']:.3f} ms over "
              f"{summary['steady_steps']} steps (CUDA events, 2 warm-up steps excluded), "
              f"{summary['images_per_sec']:.1f} img/s; peak memory {peak / 2**30:.2f} GiB; "
              f"launches {counts}", flush=True)
        runs[label] = {"launches": got, "summary": summary, "peak_bytes": peak}
    resident = {"pool-kernel": [], "library-pool": []}
    for _ in range(2):
        for label, on in (("pool-kernel", True), ("library-pool", False)):
            resident[label].append(googlenet_device_step_ms(on))
    print(f"[googlenet-main] device step with the batch resident, ms, in turns (on, off, on, "
          f"off): pool kernel {resident['pool-kernel']}, library pool {resident['library-pool']}",
          flush=True)
    runs["resident_step_ms"] = resident
    return runs


def phase_googlenet_parity(dev):
    """Full-width GoogLeNet (224x224x3, 1000 classes, fp32, dropout 0,
    pool kernel on) trained 2 momentum steps on the card and on the CPU
    (the wrappers' plain versions) from the same weights and batches."""
    import torch
    from theanompi_tpu_torch.models.googlenet import GoogLeNet
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from theanompi_tpu_torch.train import init_train_state, make_train_step
    from theanompi_tpu_torch.tree import tree_leaves

    recipe = GoogLeNet.default_recipe().replace(
        batch_size=2, compute_dtype=torch.float32,
        sched_kwargs={"lr": 0.001, "total_steps": 60, "power": 0.5})
    model = _no_dropout(GoogLeNet(recipe, pool_kernel=True))
    rng = torch.Generator().manual_seed(3)
    xs = [torch.randn(2, 224, 224, 3, generator=rng) for _ in range(2)]
    ys = [torch.randint(0, 1000, (2,), generator=rng) for _ in range(2)]
    out = {}
    for d in ("cpu", dev):
        state = init_train_state(model, torch.Generator().manual_seed(7), d)
        before = [p.detach().cpu().clone() for p in tree_leaves(state.params)]
        reset_launch_counts()
        with torch.no_grad():
            logits, _ = model.apply(state.params, {}, xs[0].to(d), train=True)
        logits = [t.cpu() for t in logits]
        step = make_train_step(model, fused_update=True)
        losses = []
        for x, y in zip(xs, ys):
            state, m = step(state, x.to(d), y.to(d), None)
            losses.append(float(m["loss"]))
        after = [p.detach().cpu() for p in tree_leaves(state.params)]
        vels = [v.detach().cpu() for v in tree_leaves(state.opt_state["vel"])]
        out[str(d)] = (losses, logits, [a - b for a, b in zip(after, before)], vels,
                       launch_counts())
    (lc, oc, dc, vc, kc), (lg, og, dg, vg, kg) = out["cpu"], out[str(dev)]
    check(not any(kc.values()), f"the CPU run launched kernels: {kc}")
    want = {"maxpool3x3_fwd": 27, "maxpool3x3_bwd": 18, "fused_momentum": update_launches(128) * 2}
    check({k: kg[k] for k in want} == want, f"the card run launched {kg}, expected {want}")
    logit_x = max(_rel_excess(a, b, 1e-4, 1e-4 * b.abs().max().item()) for a, b in zip(og, oc))
    check(logit_x <= 1, f"card logits differ from the CPU's beyond rtol 1e-4 + 1e-4 max "
                        f"(x{logit_x:.3g})")
    check(all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(lc, lg)),
          f"card losses {lg} vs CPU {lc}")
    worst = {"parameter change": 0.0, "velocity": 0.0}
    elementwise = {"parameter change": 0.0, "velocity": 0.0}
    for what, cpu, card in (("parameter change", dc, dg), ("velocity", vc, vg)):
        for i, (a, b) in enumerate(zip(cpu, card)):
            check(a.abs().max().item() > 0 and b.abs().max().item() > 0,
                  f"leaf {i}: no {what} on the card or CPU")
            rel = ((a - b).norm() / a.norm()).item()
            worst[what] = max(worst[what], rel)
            elementwise[what] = max(elementwise[what], (((a - b).abs() - 1e-3 * a.abs()).max()
                                                        / a.abs().max()).item())
            check(rel <= 1e-1, f"leaf {i}: card {what} differs from CPU by {rel:.3g} of its "
                               "norm (limit 1e-1)")
    print(f"[googlenet-parity] logits at init within rtol 1e-4 + 1e-4 max (x{logit_x:.3g}); "
          f"losses card {lg} vs CPU {lc}; worst leaf ||card - CPU|| / ||CPU|| (limit 1e-1): "
          f"{worst}; for the record, elementwise beyond rtol 1e-3 as a share of the leaf's "
          f"largest value (phase parity's 2e-3 limit, not held here): {elementwise}",
          flush=True)
    return {"logit_excess": logit_x, "rel_norm": worst, "elementwise": elementwise}


# phase graph: each model through the CLI, eager and in groups of
# GRAPH_K captured steps, over GRAPH_STEPS steps of GRAPH_EPOCH an epoch
# (so the last group of each epoch is cut: 4 4 | 4 2)
GRAPH_STEPS = 14
GRAPH_EPOCH = 8
GRAPH_K = 4


def graph_runs():
    """``{label: (CLI argv without the group flag, {kernel: launches
    expected})}``: full-width AlexNet on uint8 ImageNet batches, the 136M
    LM, GoogLeNet at 512 with the pool kernels."""
    vals = 2  # one validation batch after each of the 2 epochs
    return {
        "alexnet": (["BSP", "1", "alexnet", "AlexNet", "--dataset", "imagenet_synthetic",
                     "--fused-update", "--dataset-arg", f"n_train={128 * GRAPH_EPOCH}",
                     "--dataset-arg", "n_val=128"],
                    {"fused_momentum": GRAPH_STEPS}),
        "lm_136m": (["BSP", "1", "transformer_lm", "TransformerLM_136M", "--synthetic",
                     "--dataset-arg", f"n_train={LM_SHAPE['B'] * GRAPH_EPOCH}",
                     "--dataset-arg", f"n_val={LM_VAL}"],
                    {"flash_fwd_sm90": LM_LAYERS * (GRAPH_STEPS + vals),
                     "flash_dq_sm90": LM_LAYERS * GRAPH_STEPS,
                     "flash_dkv_sm90": LM_LAYERS * GRAPH_STEPS}),
        "googlenet": (["BSP", "1", "googlenet", "GoogLeNet", "--dataset", "imagenet_synthetic",
                       "--pool-kernel", "--fused-update", "--batch-size", str(GNET_BATCH),
                       "--dataset-arg", f"n_train={GNET_BATCH * GRAPH_EPOCH}",
                       "--dataset-arg", f"n_val={GNET_BATCH}"],
                      {"maxpool3x3_fwd": 9 * (GRAPH_STEPS + vals),
                       "maxpool3x3_bwd": 9 * GRAPH_STEPS, "fused_momentum": GRAPH_STEPS}),
    }


# tools/bench.py per model: (kwargs, steps a call); 3 timed calls each
GRAPH_BENCH = {
    "alexnet": ({"fused_update": True}, 10),
    "lm_136m": ({}, 5),
    "googlenet": ({"fused_update": True, "pool_kernel": True}, 5),
}


def graph_recapture_check() -> dict:
    """A state whose tensors are replaced between groups (as a resume's
    ``bridge.state_from_flat`` replaces them) is captured again, never
    replayed over the old pointers: full-width AlexNet (dropout on) with
    a resident batch, two groups of 2 with every leaf of the state cloned
    between them, against 4 eager steps of an engine from the same seeds.
    Losses and final state bit-identical; 2 captures, 3 replays."""
    import torch
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.train import TrainState
    from theanompi_tpu_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(128, 227, 227, 3, generator=gen, device=dev)
    y = torch.randint(0, 1000, (128,), generator=gen, device=dev)

    def fresh():
        engine = BSPEngine(AlexNet(), 1, dev, steps_per_epoch=10_000, fused_update=True)
        return (engine, engine.init_state(torch.Generator().manual_seed(0)),
                torch.Generator(device=dev).manual_seed(1))

    engine, state, g = fresh()
    eager = []
    for _ in range(4):
        state, m = engine.train_step(state, x, y, g)
        eager.append(float(m["loss"]))
    engine2, state2, g2 = fresh()
    state2, m1 = engine2.fused_train_step(state2, [x, x], [y, y], g2)
    state2 = TrainState(*[tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad),
                                   f) for f in state2])
    state2, m2 = engine2.fused_train_step(state2, [x, x], [y, y], g2)
    got = m1["loss"].tolist() + m2["loss"].tolist()
    graph = engine2.graph
    check(got == eager, f"recapture: losses {got} != eager {eager}")
    check((graph.captures, graph.replays) == (2, 3),
          f"recapture: {graph.captures} captures and {graph.replays} replays, expected 2 and 3")
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves((state.params, state.opt_state)),
                                                  tree_leaves((state2.params, state2.opt_state))))
    check(same, "recapture: the final params or velocities differ from the eager run's")
    print(f"[graph] a replaced state was captured again (2 captures, 3 replays); 4 steps "
          f"bit-identical to eager: {got}", flush=True)
    return {"losses": got, "captures": graph.captures, "replays": graph.replays}


def phase_graph():
    """Step fusion on the card: each model of ``graph_runs`` through the
    CLI eagerly and with ``--steps-per-dispatch GRAPH_K`` (counters zeroed
    just before each run and read just after). The pair must agree bit
    for bit (every loss, the validation metrics, the final params and
    velocities' digest) and launch the same kernels the same number of
    times; the grouped run must have replayed one capture for every step
    but the first. Then ``tools/bench.py``'s compute mode of each model,
    eager and captured, whose last losses must agree too."""
    import gc

    import torch
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from theanompi_tpu_torch.tools.bench import bench_compute

    out = {}
    for label, (argv, want) in graph_runs().items():
        pair = {}
        for mode, k in (("eager", 1), ("captured", GRAPH_K)):
            full = [*argv, "--epochs", "2", "--max-steps", str(GRAPH_STEPS), "--seed", "0",
                    "--steps-per-dispatch", str(k)]
            print(f"[graph] python -m theanompi_tpu_torch.cli {' '.join(full)}", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
            reset_launch_counts()
            summary = run_cli(full)
            counts = launch_counts()
            losses = summary["losses"]
            check(summary["steps"] == GRAPH_STEPS and len(losses) == GRAPH_STEPS
                  and all(math.isfinite(v) for v in losses) and summary["nonfinite_steps"] == 0,
                  f"graph {label} {mode}: steps {summary['steps']}, losses {losses}")
            got = {n: counts[n] for n in want}
            check(got == want, f"graph {label} {mode} launched {got}, expected {want}")
            stray = {n: v for n, v in counts.items() if n not in want and v}
            check(not stray, f"graph {label} {mode} launched other kernels: {stray}")
            pair[mode] = {"summary": summary, "launches": counts}
        eager, cap = pair["eager"]["summary"], pair["captured"]["summary"]
        check(eager["captured"] is False and cap["captured"] is True
              and cap["graph"] == {"captures": 1, "replays": GRAPH_STEPS - 1},
              f"graph {label}: eager captured {eager['captured']}, grouped captured "
              f"{cap['captured']} with {cap['graph']} (expected 1 capture and "
              f"{GRAPH_STEPS - 1} replays)")
        check(cap["losses"] == eager["losses"],
              f"graph {label}: captured losses {cap['losses']} != eager {eager['losses']}")
        check(cap["val"] == eager["val"],
              f"graph {label}: captured val {cap['val']} != eager {eager['val']}")
        check(cap["replica_digest_per_rank"] == eager["replica_digest_per_rank"],
              f"graph {label}: final params/velocities differ (digests "
              f"{cap['replica_digest_per_rank']} vs {eager['replica_digest_per_rank']})")
        check(pair["captured"]["launches"] == pair["eager"]["launches"],
              f"graph {label}: launch counts differ: captured {pair['captured']['launches']}, "
              f"eager {pair['eager']['launches']}")
        print(f"[graph] {label}: eager and {GRAPH_K}-step groups bit-identical (losses, val, "
              f"digest {cap['replica_digest_per_rank'][0]}), launches equal; CLI step "
              f"{eager['step_ms']:.3f} ms eager, {cap['step_ms']:.3f} ms captured "
              f"({eager['images_per_sec']:.2f} / {cap['images_per_sec']:.2f} per s); by epoch "
              f"{eager['epoch_step_ms']} / {cap['epoch_step_ms']} (an epoch's first group "
              f"waits for its {GRAPH_K} batches)", flush=True)
        bench = {}
        kw, steps = GRAPH_BENCH[label]
        for mode in ("eager", "captured"):
            gc.collect()
            torch.cuda.empty_cache()
            bench[mode] = bench_compute(label, steps=steps, trials=3, eager=mode == "eager", **kw)
            print(f"[graph] bench {json.dumps(bench[mode])}", flush=True)
        check(bench["captured"]["captured"] and not bench["eager"]["captured"]
              and bench["captured"]["last_losses"] == bench["eager"]["last_losses"],
              f"graph bench {label}: captured {bench['captured']['last_losses']} vs eager "
              f"{bench['eager']['last_losses']}")
        out[label] = {"eager": pair["eager"], "captured": pair["captured"], "bench": bench}
    gc.collect()
    torch.cuda.empty_cache()
    out["recapture"] = graph_recapture_check()
    return out


def phase_capture_failure(dev):
    """A step with a host sync cannot be captured: the runner must raise,
    naming the line, and not fall back to eager steps."""
    import torch
    from theanompi_tpu_torch.graphs import GraphCaptureError, StepGraph

    def host_sync_step(state, x, y, gen):
        scale = float(x.abs().max())  # reads the card back: no capture takes it
        return (state[0] + scale,), {"loss": (x * scale).sum()}

    state = (torch.zeros(4, device=dev),)
    x = torch.ones(4, device=dev)
    graph = StepGraph(host_sync_step, dev)
    try:
        graph.run(state, [x, x], [x, x], None)
    except GraphCaptureError as e:
        msg = str(e)
    else:
        raise Failed("a step with a host sync was captured")
    check("host_sync_step" in msg and "float(x.abs().max())" in msg and graph.replays == 0,
          f"the capture error does not name the host sync: {msg}")
    print(f"[capture-failure] refused as it must be: {msg[:300]}", flush=True)
    return msg


def copy_rate(dev) -> dict:
    """The card's streaming rate, measured once as a yardstick (not a
    kernel of the port): ``dst.copy_(src)`` over a 2 GB buffer, read +
    write bytes over CUDA-event time."""
    import torch

    src = torch.ones(10 ** 9, dtype=torch.bfloat16, device=dev)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=20, warmup=5)
    moved = 2 * src.numel() * src.element_size()
    rate = moved / (ms * 1e-3)
    del src, dst
    torch.cuda.empty_cache()
    print(f"[times] copy rate: dst.copy_(src) over {moved / 2e9:.1f} GB: {ms:.4f} ms, "
          f"{rate / 1e12:.4f} TB/s read + write ({rate / 3.35e12 * 100:.1f}% of the data "
          "sheet's 3.35 TB/s)", flush=True)
    return {"ms": ms, "bytes": moved, "rate": rate}


def phase_pool_times(dev, mem_rate, fp32_peak):
    """#12 and #13 over the nine inception pools at batch 512 in bf16 (one
    training step's launches): time, bound (at the data sheet's rate and
    at the measured copy rate), plain version, F.max_pool2d in
    channels_last as the yardstick."""
    import torch
    import torch.nn.functional as F
    from theanompi_tpu_torch.ops import pool as tp

    copy = copy_rate(dev)
    g = torch.Generator(device=dev).manual_seed(13)
    shapes = inception_pool_shapes()
    xs = [torch.relu(torch.randn(s, generator=g, device=dev)).to(torch.bfloat16) for s in shapes]
    gs = [torch.randn(s, generator=g, device=dev).to(torch.bfloat16) for s in shapes]
    ys = [tp.maxpool3x3_fwd(x) for x in xs]
    elems = sum(x.numel() for x in xs)
    tensor_bytes = 2 * elems  # one bf16 pass over the nine inputs
    xr = [x.permute(0, 3, 1, 2).detach().requires_grad_(True) for x in xs]
    yr = [F.max_pool2d(a, 3, 1, 1) for a in xr]
    gr = [gg.permute(0, 3, 1, 2) for gg in gs]
    specs = {
        # name: (kernel, plain, library, passes, ops per element)
        "maxpool3x3_fwd": (lambda i: tp.maxpool3x3_fwd(xs[i]),
                           lambda i: tp.maxpool3x3_fwd_plain(xs[i]),
                           lambda i: F.max_pool2d(xr[i].detach(), 3, 1, 1), 2, 8),
        "maxpool3x3_bwd": (lambda i: tp.maxpool3x3_bwd(xs[i], ys[i], gs[i]),
                           lambda i: tp.maxpool3x3_bwd_plain(xs[i], ys[i], gs[i]),
                           lambda i: torch.autograd.grad(yr[i], xr[i], gr[i], retain_graph=True),
                           4, 18),
    }
    k = len(shapes)
    results = {}
    for name, (kern, plain, lib, passes, ope) in specs.items():
        per = [cuda_ms(lambda i=i: kern(i), reps=20) for i in range(k)]
        step_ms = cuda_ms(lambda: [kern(i) for i in range(k)], reps=20)
        plain_ms = cuda_ms(lambda: [plain(i) for i in range(k)], reps=5)
        lib_ms = cuda_ms(lambda: [lib(i) for i in range(k)], reps=20)
        byts = passes * tensor_bytes
        ops = ope * elems
        bytes_ms, ops_ms = byts / mem_rate * 1e3, ops / fp32_peak * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        measured_ms = max(byts / copy["rate"] * 1e3, ops_ms)
        results[name] = dict(step_ms=step_ms, per_launch_ms=per, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound_ms, bytes=byts, ops=ops,
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                             bound_ms_measured_rate=measured_ms, copy_rate=copy)
        print(f"[times] {name}: {step_ms:.4f} ms/step ({k} launches, {elems} elements) | bound "
              f"{bound_ms:.4f} ms ({byts / 1e6:.1f} MB; {results[name]['bound_by']}) | "
              f"{bound_ms / step_ms * 100:.1f}% of bound | at the measured copy rate "
              f"{measured_ms:.4f} ms, {measured_ms / step_ms * 100:.1f}% | plain "
              f"{plain_ms:.4f} ms | F.max_pool2d channels_last "
              f"{'forward' if name.endswith('fwd') else 'backward'} {lib_ms:.4f} ms", flush=True)
        for s, t in zip(shapes, per):
            print(f"[times]   {name} {str(s):22s} {t * 1e3:9.2f} us/launch (bound "
                  f"{passes * 2 * math.prod(s) / mem_rate * 1e6:8.2f} us; at the copy rate "
                  f"{passes * 2 * math.prod(s) / copy['rate'] * 1e6:8.2f} us)", flush=True)
    lib_fwd_bwd = cuda_ms(lambda: [torch.autograd.grad(F.max_pool2d(a, 3, 1, 1), a, b)
                                   for a, b in zip(xr, gr)], reps=20)
    results["maxpool3x3_bwd"]["library_fwd_bwd_ms"] = lib_fwd_bwd
    results["maxpool3x3_fwd"]["library_fwd_bwd_ms"] = lib_fwd_bwd
    print(f"[times] F.max_pool2d channels_last forward + backward over the nine: "
          f"{lib_fwd_bwd:.4f} ms; kernels #12 + #13: "
          f"{results['maxpool3x3_fwd']['step_ms'] + results['maxpool3x3_bwd']['step_ms']:.4f} ms",
          flush=True)
    del xr, yr, gr, xs, gs, ys
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def find_cuobjdump() -> str:
    """The toolkit's cuobjdump, else the copy in Triton's package."""
    import importlib.util

    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),
             shutil.which("cuobjdump") or "", "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        root = list(spec.submodule_search_locations)[0]
        cands.append(os.path.join(root, "backends", "nvidia", "bin", "cuobjdump"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise Failed(f"cuobjdump not found (looked at {[c for c in cands if c]})")


# kernel -> the SASS instructions its design must compile to: wgmma
# (HGMMA) and TMA loads (UTMALDG) in the sm90 kernels; mma.sync (HMMA) and
# cp.async (LDGSTS) in the mma.sync kernels, ldmatrix (LDSM) in the bf16
# ones (ILb0E: the cp.async instantiation, ILb1E: the register-staged one)
SASS_KERNELS = {"flash_fwd_sm90_kernel": ("HGMMA", "UTMALDG"),
                "flash_dq_sm90_kernel": ("HGMMA", "UTMALDG"),
                "flash_dkv_sm90_kernel": ("HGMMA", "UTMALDG"),
                "flash_fwd_mma_kernel": ("HMMA", "LDGSTS"),
                "flash_dq_mma_kernel": ("HMMA", "LDGSTS"),
                # flash_fwd_mma_bf16's instantiations: cp.async loads, register-staged loads
                "flash_fwd_mma_bf16_kernelILb0E": ("HMMA", "LDSM", "LDGSTS"),
                "flash_fwd_mma_bf16_kernelILb1E": ("HMMA", "LDSM"),
                "flash_dq_mma_bf16_kernelILb0E": ("HMMA", "LDSM", "LDGSTS"),
                "flash_dq_mma_bf16_kernelILb1E": ("HMMA", "LDSM"),
                "flash_dkv_mma_bf16_kernelILb0E": ("HMMA", "LDSM", "LDGSTS"),
                "flash_dkv_mma_bf16_kernelILb1E": ("HMMA", "LDSM", "LDGSTS"),
                "flash_dkv_mma_kernel": ("HMMA", "LDGSTS")}
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA", "LDSM", "LDGSTS")


def phase_sass():
    """Proof of design: the SASS of each kernel of ``SASS_KERNELS``, in
    the library the build phase made, holds the instructions listed
    there. Prints each one's registers, shared memory and spills."""
    from theanompi_tpu_torch.ops.kernels import library_path

    lib = str(library_path("flash_attention.cu"))
    tool = find_cuobjdump()
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr[-2000:]}")
    funcs = {}
    for chunk in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        name, _, body = chunk.partition("\n")
        funcs[name.strip()] = body
    res = subprocess.run([tool, "--dump-resource-usage", lib], capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0, f"cuobjdump --dump-resource-usage failed: {res.stderr[-2000:]}")
    lines = res.stdout.splitlines()
    proof = {}
    for kernel, needed in SASS_KERNELS.items():
        mine = [n for n in funcs if kernel in n]
        check(len(mine) == 1, f"{kernel} not found once in the SASS: {sorted(funcs)}")
        body = funcs[mine[0]]
        ops = {op: len(re.findall(rf"\b{op}\b", body)) for op in SASS_OPS}
        check(all(ops[op] > 0 for op in needed), f"{kernel}'s SASS lacks one of {needed}: {ops}")
        usage = next((lines[i + 1].strip() for i, line in enumerate(lines)
                      if kernel in line and i + 1 < len(lines)), "")
        check(usage, f"no resource usage line for {kernel}")
        print(f"[build] {os.path.basename(tool)} -sass: {kernel} has "
              + ", ".join(f"{n} {op}" for op, n in ops.items() if n)
              + f"; resources: {usage}", flush=True)
        proof[kernel] = {"sass_ops": ops, "resource_usage": usage, "function": mine[0]}
    return proof


def update_label(fn: str):
    """The fused update's instantiation in a mangled name, or None."""
    m = re.search(r"fused_update_multi_kernelI(\w+?)Lb([01])E", fn)
    if not m:
        return None
    types, momentum = m.groups()
    return (f"{'momentum' if momentum == '1' else 'sgd'} p "
            f"{'bf16' if 'bfloat16' in types else 'fp32'} g "
            f"{'fp32' if types.endswith('f') else 'bf16'}")


def codec_label(fn: str):
    """The block codec's instantiation (its op) in a mangled name, or None."""
    m = re.search(r"block_codec_multi_kernelILi([012])E", fn)
    return ("quantize", "dequantize", "dequantize-add")[int(m.group(1))] if m else None


def pool_label(fn: str):
    """The halo-tile pool kernel's instantiation in a mangled name, or None."""
    m = re.search(r"maxpool_(fwd|bwd)_tile_kernelI\w*?(F32|BF16)ELi(\d+)E", fn)
    return f"{m.group(1)} {m.group(2).lower()} vec{m.group(3)}" if m else None


def ptxas_report(source: str = "fused_update.cu", label_of=update_label, count: int = 6) -> dict:
    """What ptxas reports for each kernel instantiation in
    ``csrc/<source>`` that ``label_of`` names (``nvcc -Xptxas -v`` into a
    throwaway cubin, the build's own flags): {label: registers, stack
    frame, spill bytes, static shared memory}; there must be ``count`` of
    them."""
    import tempfile

    from theanompi_tpu_torch.ops import kernels as K

    flags = [f for f in K.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [K.nvcc_path(), *flags, "-Xptxas", "-v", "-cubin", "-o",
               os.path.join(tmp, "k.cubin"), str(K.CSRC_DIR / source)]
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"nvcc -Xptxas -v failed on {source}: {out.stderr[-2000:]}")
    report = {}
    for block in re.split(r"Compiling entry function '", out.stdout + out.stderr)[1:]:
        fn = block.split("'", 1)[0]
        label = label_of(fn)
        if label is None:
            continue
        nums = {key: re.search(pattern, block) for key, pattern in (
            ("registers", r"Used (\d+) registers"), ("stack_frame", r"(\d+) bytes stack frame"),
            ("spill_stores", r"(\d+) bytes spill stores"), ("spill_loads", r"(\d+) bytes spill loads"))}
        check(all(nums.values()), f"ptxas said nothing parseable of {fn}: {block[:500]}")
        report[label] = {key: int(v.group(1)) for key, v in nums.items()}
        smem = re.search(r"(\d+) bytes smem", block)  # static; ptxas omits it at 0
        report[label]["static_smem"] = int(smem.group(1)) if smem else 0
    check(len(report) == count, f"expected {count} kernel instantiations in ptxas's report of "
                                f"{source}, found {sorted(report)}")
    for label, r in sorted(report.items()):
        print(f"[build] ptxas: {source} {label}: {r}", flush=True)
    return report


# the input feed: a native-loader check batch at ImageNet's sizes, host
# batches timed per feed (median over FEED_BATCHES, the first left out),
# and the CLI runs long enough to drain the prefetch queue
FEED_ROWS = 256
FEED_SIDE = 256
FEED_CROP = 227
FEED_BATCHES = 11
FEED_ALEX_STEPS = 22   # 20 steady steps
FEED_GNET_STEPS = 14   # 12 steady steps


def native_cases(gen_seed: int = 0):
    """A 256-row batch of 256x256x3 uint8 images from a memory-mapped
    shard, with 227-crop offsets, flips, and the three kinds of mean."""
    import numpy as np

    r = np.random.RandomState(gen_seed)
    n, s, c = FEED_ROWS, FEED_SIDE, FEED_CROP
    images = r.randint(0, 256, size=(n, s, s, 3)).astype(np.uint8)
    oy = r.randint(0, s - c + 1, n)
    ox = r.randint(0, s - c + 1, n)
    flips = r.rand(n) < 0.5
    means = {"scalar": np.float32(127.5),
             "channel": (r.rand(3) * 255).astype(np.float32),
             "plane": (r.rand(c, c, 3) * 255).astype(np.float32)}
    return images, oy, ox, flips, means


def phase_feed(dev, shard_dir):
    """The native loader built on this host and held bit for bit against
    its numpy versions at ImageNet's sizes (1 thread and the default
    count); the card's (x - mean) * scale bit for bit against the CPU's;
    then the host batch of three feeds timed, split into gather, crop,
    pin and H2D. Writes the ImageNet shards of phase feed-main under
    ``shard_dir``."""
    import numpy as np
    import torch
    from theanompi_tpu_torch import native
    from theanompi_tpu_torch.data.loader import host_tensors, pinned_array
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.tools.profile_step import feed_dataset, feed_times, temp_shards
    from theanompi_tpu_torch.train import make_input_transform

    path, secs = native.build()
    print(f"[feed] native loader: g++ {' '.join(native.CXX_FLAGS)} -> {path.name} "
          f"({secs:.2f} s); {native.default_threads()} threads a call by default", flush=True)
    images, oy, ox, flips, means = native_cases()
    shard = os.path.join(shard_dir, "check_images.npy")
    np.save(shard, images)
    mm = np.load(shard, mmap_mode="r")
    idx = np.random.RandomState(1).permutation(FEED_ROWS)[:FEED_ROWS // 2]
    n_cases = 0
    for threads in (1, None):
        label = f"{threads or native.default_threads()} thread(s)"
        check(np.array_equal(native.gather_rows(mm, idx, n_threads=threads),
                             native.gather_rows_plain(mm, idx)),
              f"gather_rows differs from numpy's fancy index ({label})")
        got = native.crop_mirror_u8(images, oy, ox, flips, FEED_CROP, n_threads=threads)
        check(got.dtype == np.uint8 and np.array_equal(
            got, native.crop_mirror_plain(images, oy, ox, flips, FEED_CROP)),
            f"crop_mirror_u8 differs from the numpy crop + mirror ({label})")
        n_cases += 2
        for kind, mean in means.items():
            got = native.crop_mirror_normalize(images, oy, ox, flips, FEED_CROP, mean,
                                               1.0 / 58.0, n_threads=threads)
            want = native.crop_mirror_normalize_plain(images, oy, ox, flips, FEED_CROP, mean,
                                                      np.float32(1.0 / 58.0))
            check(got.dtype == np.float32 and np.array_equal(got, want),
                  f"crop_mirror_normalize ({kind} mean, {label}) differs from numpy")
            n_cases += 1
    os.remove(shard)
    crops = native.crop_mirror_u8(images[:128], oy[:128], ox[:128], flips[:128], FEED_CROP)
    x_cpu = torch.from_numpy(crops)
    x_dev = x_cpu.to(dev)
    for kind, mean in means.items():
        spec = {"mean": mean, "scale": float(np.float32(1.0 / 58.0))}
        on_card = make_input_transform(spec, dev)(x_dev).cpu()
        on_cpu = make_input_transform(spec, "cpu")(x_cpu)
        check(torch.equal(on_card, on_cpu),
              f"the card's (x - mean) * scale ({kind} mean) differs from the CPU's")
        n_cases += 1
    print(f"[feed] {n_cases} cases bit-identical: gather_rows, crop_mirror_u8, "
          "crop_mirror_normalize (scalar / per-channel / plane mean) at 1 thread and the "
          f"default count over {FEED_ROWS} rows of {FEED_SIDE}x{FEED_SIDE}x3; the card's "
          "input transform against the CPU's (three means)", flush=True)

    recipe = AlexNet.default_recipe()
    batch = recipe.batch_size
    n_host = (FEED_BATCHES + 1) * batch
    t0 = time.perf_counter()
    temp_shards(shard_dir, FEED_ALEX_STEPS * batch, batch)
    print(f"[feed] wrote {FEED_ALEX_STEPS * batch} + {batch} shard images of "
          f"{FEED_SIDE}x{FEED_SIDE}x3 ({time.perf_counter() - t0:.1f} s)", flush=True)
    # a pinned_array batch goes to the card as its own tensor, uncopied
    buf = pinned_array((batch, *recipe.input_shape), np.uint8)
    (t,) = host_tensors((buf,), True)
    check(t.is_pinned() and t.data_ptr() == buf.ctypes.data and t.shape == buf.shape,
          "host_tensors copied a pinned_array batch")
    del buf, t
    feeds = {}
    for name in ("synthetic", "imagenet_synthetic", "imagenet"):
        data = feed_dataset(name, recipe, n_host, root=shard_dir)
        # the loop's way last: every dtype is written into pinned memory
        for into_pinned in (False, True):
            f = feed_times(data, batch, dev, FEED_BATCHES, into_pinned=into_pinned)
            check(f["written_into_pinned"] == into_pinned,
                  f"{name}: written into pinned memory {f['written_into_pinned']}")
            feeds[f"{name}{'' if into_pinned else '/fresh+pin'}"] = f
            how = ("written into pinned memory" if f["written_into_pinned"] else
                   "fresh arrays, then pinned")
            print(f"[feed] {name} ({f['dtype']}, {f['batch_bytes'] / 1e6:.1f} MB a batch of "
                  f"{batch}), {how}, median of {FEED_BATCHES} ms: gather {f['gather_ms']:.3f}, "
                  f"crop {f['crop_ms']:.3f}, pin {f['pin_ms']:.3f}, host batch "
                  f"{f['host_batch_ms']:.3f}, H2D {f['h2d_ms']:.3f}", flush=True)
        if name == "synthetic":
            # the float32 rows: the native gather against numpy's fancy index
            feeds["gather_float32"] = gather_times(data.x_train, batch)
        del data
    # the LM's int32 token windows (the 350M's batch of 8 x 1024)
    windows = np.random.RandomState(3).randint(0, 32768, (64, 1024)).astype(np.int32)
    feeds["gather_int32"] = gather_times(windows, 8)
    # CIFAR's float32 batch (128 x 32 x 32 x 3, 1.5 MB), near the thread cap's 1 MB a thread
    cifar = np.random.RandomState(5).rand(1024, 32, 32, 3).astype(np.float32)
    feeds["gather_cifar_float32"] = gather_times(cifar, 128)
    del cifar
    feeds["crop"] = crop_times(images[:128], oy[:128], ox[:128])
    for k in ("gather_float32", "gather_int32", "gather_cifar_float32"):
        g = feeds[k]
        print(f"[feed] {k} ({g['rows']} rows of {g['row_bytes']} B), median of {g['reps']} ms: "
              f"native {g['native_ms']:.4f} (into pinned memory {g['native_pinned_ms']:.4f}), "
              f"numpy {g['numpy_ms']:.4f}; into pinned memory by threads {g['by_threads']} "
              f"(the cap picks {g['auto_threads']})", flush=True)
    c = feeds["crop"]
    print(f"[feed] crop_mirror_u8 of 128 rows to {FEED_CROP}x{FEED_CROP}x3, median of "
          f"{c['reps']} ms: every image mirrored {c['mirrored_ms']:.4f}, none "
          f"{c['unmirrored_ms']:.4f}, half {c['half_ms']:.4f}; numpy {c['numpy_ms']:.4f}; "
          f"crop_mirror_normalize (per-channel mean) mirrored {c['normalize_mirrored_ms']:.4f}, "
          f"none {c['normalize_unmirrored_ms']:.4f}", flush=True)
    return {"cases": n_cases, "build_seconds": secs, "feeds": feeds}


def _median_ms(fn, reps: int) -> float:
    import statistics

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def gather_times(source, rows: int, reps: int = 21) -> dict:
    """A batch of ``rows`` random rows of ``source`` (float32 images or
    int32 windows): the native gather (fresh and into pinned memory) and
    numpy's fancy index, host ms medians; the results bit for bit equal.
    Also the native gather into pinned memory at 1, 2 and 4 threads and
    the default count (``by_threads``), against the count that
    ``native.MIN_BYTES_A_THREAD`` picks for this batch (``auto_threads``)."""
    import numpy as np
    from theanompi_tpu_torch import native
    from theanompi_tpu_torch.data.loader import pinned_array

    idx = np.random.RandomState(4).permutation(len(source))[:rows]
    pinned = pinned_array((rows, *source.shape[1:]), source.dtype)
    got = native.gather_rows(source, idx, out=pinned)
    check(got.tobytes() == source[idx].tobytes(),
          f"the native gather of {source.dtype} rows differs from numpy's fancy index")
    counts = sorted({1, 2, 4, native.default_threads()})
    return {"rows": rows, "row_bytes": int(source[0].nbytes), "reps": reps,
            "dtype": str(source.dtype),
            "auto_threads": native._threads(None, pinned.nbytes),
            "by_threads": {t: _median_ms(lambda t=t: native.gather_rows(
                source, idx, n_threads=t, out=pinned), reps) for t in counts},
            "native_ms": _median_ms(lambda: native.gather_rows(source, idx), reps),
            "native_pinned_ms": _median_ms(lambda: native.gather_rows(source, idx, out=pinned),
                                           reps),
            "numpy_ms": _median_ms(lambda: native.gather_rows_plain(source, idx), reps)}


def crop_times(images, oy, ox, reps: int = 21) -> dict:
    """The native crop + mirror of a batch with every image mirrored, none
    and half, numpy's crop + mirror, and the normalizing crop mirrored
    and not: host ms medians (threads: the default count)."""
    import numpy as np
    from theanompi_tpu_torch import native

    n = len(images)
    every, none = np.ones(n, bool), np.zeros(n, bool)
    half = np.arange(n) % 2 == 0
    mean = np.float32([123.7, 116.3, 103.5])
    check(np.array_equal(native.crop_mirror_u8(images, oy, ox, every, FEED_CROP),
                         native.crop_mirror_plain(images, oy, ox, every, FEED_CROP)),
          "the mirrored crop differs from numpy's")

    def u8(flips):
        return lambda: native.crop_mirror_u8(images, oy, ox, flips, FEED_CROP)

    def norm(flips):
        return lambda: native.crop_mirror_normalize(images, oy, ox, flips, FEED_CROP, mean,
                                                    1.0 / 58.0)

    return {"reps": reps, "threads": native.default_threads(),
            "mirrored_ms": _median_ms(u8(every), reps),
            "unmirrored_ms": _median_ms(u8(none), reps),
            "half_ms": _median_ms(u8(half), reps),
            "numpy_ms": _median_ms(
                lambda: native.crop_mirror_plain(images, oy, ox, half, FEED_CROP), 5),
            "normalize_mirrored_ms": _median_ms(norm(every), reps),
            "normalize_unmirrored_ms": _median_ms(norm(none), reps)}


def resident_step_ms(model_name: str, pool_kernel: bool = False, steps: int = 10,
                     warmup: int = 3) -> float:
    """One training step with a uint8 batch resident on the card, normalized
    in the step as the feed's CLI runs do (BSPEngine, --fused-update):
    AlexNet at batch 128 or GoogLeNet at batch 512. CUDA events."""
    import torch
    from theanompi_tpu_torch.data.imagenet import MEAN, SCALE
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.models.googlenet import GoogLeNet
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.train import make_input_transform

    dev = torch.device("cuda", torch.cuda.current_device())
    if model_name == "googlenet":
        model = GoogLeNet(GoogLeNet.default_recipe().replace(batch_size=GNET_BATCH),
                          pool_kernel=pool_kernel)
    else:
        model = AlexNet()
    r = model.recipe
    engine = BSPEngine(model, 1, dev, steps_per_epoch=10_000, fused_update=True,
                       input_transform=make_input_transform(
                           {"mean": MEAN, "scale": float(SCALE)}, dev))
    box = {"state": engine.init_state(torch.Generator().manual_seed(0))}
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, 256, (r.batch_size, *r.input_shape), generator=gen, device=dev,
                      dtype=torch.uint8)
    y = torch.randint(0, r.num_classes, (r.batch_size,), generator=gen, device=dev)

    def step():
        box["state"], _ = engine.train_step(box["state"], x, y, gen)

    ms = cuda_ms(step, reps=steps, warmup=warmup)
    del box, x, y, engine
    torch.cuda.empty_cache()
    return ms


def phase_feed_main(shard_dir):
    """The feed through the CLI: AlexNet on imagenet_synthetic and on the
    ImageNet shards (10-crop validation), GoogLeNet at batch 512 on
    imagenet_synthetic with the pool kernels; kernel and native counters
    zeroed just before each run and read just after. Each run's step
    against the same model's resident uint8 step."""
    import torch
    from theanompi_tpu_torch import native
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    runs = {}
    for label, model, steps, extra in (
        ("alexnet-imagenet_synthetic", "alexnet", FEED_ALEX_STEPS,
         ["--dataset", "imagenet_synthetic", "--dataset-arg", f"n_train={128 * FEED_ALEX_STEPS}",
          "--dataset-arg", "n_val=128"]),
        ("alexnet-imagenet", "alexnet", FEED_ALEX_STEPS,
         ["--dataset", "imagenet", "--dataset-arg", f"root={shard_dir}",
          "--dataset-arg", "val_crops=10"]),
        ("googlenet-imagenet_synthetic", "googlenet", FEED_GNET_STEPS,
         ["--dataset", "imagenet_synthetic", "--pool-kernel", "--batch-size", str(GNET_BATCH),
          "--dataset-arg", f"n_train={GNET_BATCH * FEED_GNET_STEPS}",
          "--dataset-arg", f"n_val={GNET_BATCH}"]),
    ):
        cls = "AlexNet" if model == "alexnet" else "GoogLeNet"
        # the default print frequency: no per-step read-back, as a user runs
        argv = ["BSP", "1", model, cls, "--fused-update", "--max-steps", str(steps),
                "--seed", "0", *extra]
        print(f"[feed-main] python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
        torch.cuda.empty_cache()
        reset_launch_counts()
        native.LOADER.reset()
        summary = run_cli(argv)
        counts = launch_counts()
        calls = dict(native.LOADER.calls)
        losses = summary["losses"]
        check(summary["steps"] == steps and len(losses) == steps
              and all(math.isfinite(v) for v in losses) and summary["nonfinite_steps"] == 0,
              f"feed-main {label}: steps {summary['steps']}, losses {losses}")
        check("val" in summary and all(math.isfinite(v) for v in summary["val"].values()),
              f"feed-main {label}: bad val metrics {summary.get('val')}")
        check(summary["device_normalize"] and summary["steady_steps"] == steps - 2,
              f"feed-main {label}: device_normalize {summary['device_normalize']}, "
              f"steady steps {summary['steady_steps']}")
        gnet = model == "googlenet"
        want = {"maxpool3x3_fwd": 9 * (steps + 1) if gnet else 0,
                "maxpool3x3_bwd": 9 * steps if gnet else 0,
                "fused_momentum": update_launches(128 if gnet else 16) * steps}
        got = {k: counts[k] for k in want}
        check(got == want, f"feed-main {label} launched {got}, expected {want}")
        stray = {k: v for k, v in counts.items() if k not in want and v}
        check(not stray, f"feed-main {label} launched other kernels: {stray}")
        native_want = ["tmpi_gather_rows"] + (["tmpi_crop_mirror_u8"]
                                              if label.endswith("-imagenet") else [])
        check(all(calls.get(k, 0) >= steps for k in native_want),
              f"feed-main {label}: native calls {calls}, expected >= {steps} of {native_want}")
        if label == "alexnet-imagenet":
            check(summary["eval_views"] == 10, f"feed-main {label}: {summary['eval_views']} views")
        resident = [resident_step_ms(model, pool_kernel=gnet) for _ in range(2)]
        ratio = summary["step_ms"] / min(resident)
        print(f"[feed-main] {label}: per-step loss {losses}; val {summary['val']}", flush=True)
        print(f"[feed-main] {label}: CLI step {summary['step_ms']:.3f} ms over "
              f"{summary['steady_steps']} steady steps, {summary['images_per_sec']:.1f} img/s; "
              f"resident uint8 device step {resident} ms; CLI / resident {ratio:.3f}; the loop "
              f"waited {summary['feed_wait_ms_per_rank'][0]:.3f} ms a step on the loader; "
              f"launches {got}; native calls {calls}", flush=True)
        runs[label] = {"launches": got, "summary": summary, "resident_step_ms": resident,
                       "cli_over_resident": ratio, "native_calls": calls}
    return runs


# phase zoo-main: WRN-28-10 (BASELINE config #1) through the CLI at its
# recipe's batch, eagerly and in groups of GRAPH_K, over ZOO_STEPS steps of
# ZOO_EPOCH an epoch; its resume over ZOO_RESUME steps; ResNet-50 and
# VGG16 at their zoo batches for ZOO_IMNET_STEPS steps; cifar10 and the
# MLP for ZOO_SMALL_STEPS
ZOO_STEPS = 14
ZOO_EPOCH = 8
ZOO_RESUME = 6
ZOO_IMNET_STEPS = 6
ZOO_SMALL_STEPS = 3


def zoo_leaves(zoo_name: str) -> int:
    """Parameter leaves of a zoo model at its recipe's shapes (meta device)."""
    from theanompi_tpu_torch.tools.update_variants import leaf_specs

    return len(leaf_specs(zoo_name))


def bn_entries(path: str) -> dict:
    """The BN statistics (``.model_state/...`` entries) of a checkpoint file."""
    from theanompi_tpu_torch.utils.checkpoint import load_checkpoint

    return {k: v for k, v in load_checkpoint(path).items() if k.startswith(".model_state/")}


def zoo_cli(label: str, argv: list, want: dict) -> dict:
    """One CLI run of phase zoo-main: counters zeroed just before it and
    read just after, peak memory, finite losses and validation, and the
    launches ``want`` (every other counter 0)."""
    import gc

    import torch
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    print(f"[zoo-main] {label}: python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    summary = run_cli(argv)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = summary["losses"]
    ran = summary["steps"] - (summary["resumed_from_step"] or 0)
    check(len(losses) == ran and all(math.isfinite(v) for v in losses)
          and summary["nonfinite_steps"] == 0, f"zoo {label}: losses {losses}")
    check("val" in summary and all(math.isfinite(v) for v in summary["val"].values()),
          f"zoo {label}: bad val metrics {summary.get('val')}")
    got = {k: counts[k] for k in want}
    check(got == want, f"zoo {label} launched {got}, expected {want}")
    stray = {k: v for k, v in counts.items() if k not in want and v}
    check(not stray, f"zoo {label} launched other kernels: {stray}")
    print(f"[zoo-main] {label}: losses {losses}; val {summary['val']}; step "
          f"{summary['step_ms']:.3f} ms over {summary['steady_steps']} steps (CUDA events, 2 "
          f"warm-up steps excluded), {summary['images_per_sec']:.1f} img/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {got}", flush=True)
    return {"summary": summary, "launches": counts, "peak_bytes": peak}


def zoo_resident_peak(zoo_name: str, steps: int = 2) -> dict:
    """A model at its ``zoo_entry`` batch: ``steps`` training steps
    (--fused-update) with a float32 batch resident on the card -> the step
    ms (CUDA events, one warm-up step) and the peak memory: the batch fits
    one card."""
    import gc

    import torch
    from theanompi_tpu_torch.models.zoo import zoo_entry
    from theanompi_tpu_torch.parallel.bsp import BSPEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda", torch.cuda.current_device())
    cls, batch = zoo_entry(zoo_name)
    model = cls(cls.default_recipe().replace(batch_size=batch))
    r = model.recipe
    engine = BSPEngine(model, 1, dev, steps_per_epoch=10_000, fused_update=True)
    box = {"state": engine.init_state(torch.Generator().manual_seed(0))}
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(batch, *r.input_shape, generator=gen, device=dev)
    y = torch.randint(0, r.num_classes, (batch,), generator=gen, device=dev)

    def step():
        box["state"], m = engine.train_step(box["state"], x, y, gen)
        box["loss"] = m["loss"]

    ms = cuda_ms(step, reps=steps, warmup=1)
    loss = float(box["loss"])
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss), f"zoo {zoo_name} at {batch}: loss {loss}")
    del box, x, y, engine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[zoo-main] {zoo_name} at its zoo_entry batch {batch}: step {ms:.3f} ms, peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    return {"batch": batch, "step_ms": ms, "peak_bytes": peak}


def phase_zoo_main():
    """The rest of the CNN zoo through the CLI on one card (module
    docstring, phase zoo-main)."""
    from theanompi_tpu_torch.models.zoo import zoo_entry
    from theanompi_tpu_torch.utils.checkpoint import load_checkpoint

    root = tempfile.mkdtemp(prefix="tmpi-zoo-")
    out = {}
    try:
        wrn_leaves = zoo_leaves("wrn")
        per_step = update_launches(wrn_leaves)
        wrn = ["BSP", "1", "wrn", "WRN", "--synthetic", "--fused-update", "--seed", "0",
               "--dataset-arg", f"n_train={128 * ZOO_EPOCH}", "--dataset-arg", "n_val=128"]
        pair = {}
        for mode, k in (("eager", 1), ("captured", GRAPH_K)):
            d = os.path.join(root, f"wrn-{mode}")
            pair[mode] = zoo_cli(f"wrn {mode}", [
                *wrn, "--epochs", "2", "--max-steps", str(ZOO_STEPS), "--print-freq", "1",
                "--steps-per-dispatch", str(k), "--ckpt-dir", d, "--sync-ckpt"],
                {"fused_momentum": per_step * ZOO_STEPS})
            pair[mode]["bn"] = bn_entries(pair[mode]["summary"]["checkpoints"][-1]["path"])
        eager, cap = pair["eager"]["summary"], pair["captured"]["summary"]
        check(eager["captured"] is False and cap["captured"] is True
              and cap["graph"] == {"captures": 1, "replays": ZOO_STEPS - 1},
              f"zoo wrn: eager captured {eager['captured']}, grouped {cap['captured']} with "
              f"{cap['graph']} (expected 1 capture and {ZOO_STEPS - 1} replays)")
        check(cap["losses"] == eager["losses"] and cap["val"] == eager["val"],
              f"zoo wrn: captured losses {cap['losses']} / val {cap['val']} != eager "
              f"{eager['losses']} / {eager['val']}")
        check(cap["replica_digest_per_rank"] == eager["replica_digest_per_rank"],
              f"zoo wrn: final params/velocities differ ({cap['replica_digest_per_rank']} vs "
              f"{eager['replica_digest_per_rank']})")
        bn_e, bn_c = pair["eager"]["bn"], pair["captured"]["bn"]
        check(len(bn_e) == 50 and sorted(bn_e) == sorted(bn_c)
              and all(bn_e[k].tobytes() == bn_c[k].tobytes() for k in bn_e),
              f"zoo wrn: the final BN statistics differ between eager and captured runs "
              f"({len(bn_e)} / {len(bn_c)} entries)")
        check(pair["captured"]["launches"] == pair["eager"]["launches"],
              f"zoo wrn: launch counts differ: {pair['captured']['launches']} vs "
              f"{pair['eager']['launches']}")
        print(f"[zoo-main] wrn: eager and {GRAPH_K}-step groups bit-identical (losses, val, "
              f"digest {cap['replica_digest_per_rank'][0]}, the {len(bn_e)} BN statistics of the "
              f"final checkpoint), fused_momentum {per_step} a step over {wrn_leaves} leaves "
              f"(Nesterov); step {eager['step_ms']:.3f} ms eager, {cap['step_ms']:.3f} ms captured",
              flush=True)
        out["wrn"] = pair

        # resume: 3 steps, then --resume to ZOO_RESUME, against an uninterrupted run
        res = {}
        for name, steps, flags in (("control", ZOO_RESUME, []), ("resumed", ZOO_RESUME // 2, []),
                                   ("resumed", ZOO_RESUME, ["--resume"])):
            d = os.path.join(root, f"wrn-{name}")
            n = steps - (ZOO_RESUME // 2 if flags else 0)
            res[f"{name}{'+' if flags else ''}"] = zoo_cli(f"wrn {name} {' '.join(flags)}", [
                *wrn, "--max-steps", str(steps), "--print-freq", "1", "--ckpt-dir", d,
                "--sync-ckpt", *flags], {"fused_momentum": per_step * n})
        ctrl, first, resumed = res["control"], res["resumed"], res["resumed+"]
        r = resumed["summary"]
        check(r["resumed_from_step"] == ZOO_RESUME // 2
              and r["resume"]["digest"] == first["summary"]["checkpoints"][-1]["digest"],
              f"zoo wrn resume: from {r.get('resumed_from_step')}, digest {r.get('resume')}")
        check(first["summary"]["losses"] + r["losses"] == ctrl["summary"]["losses"],
              f"zoo wrn resume: losses {first['summary']['losses']} + {r['losses']} != "
              f"{ctrl['summary']['losses']}")
        a = load_checkpoint(ctrl["summary"]["checkpoints"][-1]["path"])
        b = load_checkpoint(r["checkpoints"][-1]["path"])
        check(sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes() for k in a),
              "zoo wrn resume: the resumed run's final checkpoint differs from the "
              "uninterrupted run's: " + str([k for k in a if k not in b or
                                             a[k].tobytes() != b[k].tobytes()][:5]))
        n_bn = sum(k.startswith(".model_state/") for k in a)
        print(f"[zoo-main] wrn resume: {ZOO_RESUME // 2} steps + --resume to {ZOO_RESUME} equal "
              f"to the uninterrupted run, all {len(a)} checkpoint entries bit for bit ({n_bn} BN "
              f"statistics)", flush=True)
        out["wrn_resume"] = res

        for zoo in ("resnet50", "vgg16"):
            cls, batch = zoo_entry(zoo)
            out[zoo] = zoo_cli(zoo, [
                "BSP", "1", zoo, cls.__name__, "--dataset", "imagenet_synthetic", "--fused-update",
                "--batch-size", str(batch), "--max-steps", str(ZOO_IMNET_STEPS),
                "--print-freq", "1", "--seed", "0",
                "--dataset-arg", f"n_train={batch * ZOO_IMNET_STEPS}",
                "--dataset-arg", f"n_val={batch}"],
                {"fused_momentum": update_launches(zoo_leaves(zoo)) * ZOO_IMNET_STEPS})
        for label, module, cls in (("cifar10", "cifar10", "Cifar10_model"),
                                   ("mlp", "theanompi_tpu_torch.models.mlp", "MLP")):
            batch = 128 if label == "cifar10" else 64
            out[label] = zoo_cli(label, [
                "BSP", "1", module, cls, "--synthetic", "--fused-update",
                "--max-steps", str(ZOO_SMALL_STEPS), "--print-freq", "1", "--seed", "0",
                "--dataset-arg", f"n_train={batch * ZOO_SMALL_STEPS}",
                "--dataset-arg", f"n_val={batch}"],
                {"fused_momentum": update_launches(zoo_leaves(label)) * ZOO_SMALL_STEPS})
        for zoo in ("wrn", "alexnet"):  # the zoo_entry batches that zoo-main runs nowhere else
            out[f"{zoo}_zoo_batch"] = zoo_resident_peak(zoo)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("[zoo-main] " + json.dumps({
        k: {"step_ms": v["summary"]["step_ms"], "images_per_sec": v["summary"]["images_per_sec"],
            "peak_bytes": v["peak_bytes"]}
        for k, v in (("wrn-eager", out["wrn"]["eager"]), ("wrn-captured", out["wrn"]["captured"]),
                     ("resnet50", out["resnet50"]), ("vgg16", out["vgg16"]),
                     ("cifar10", out["cifar10"]), ("mlp", out["mlp"]))}), flush=True)
    return out


def phase_zoo_parity(dev):
    """WRN-28-10 at full width (fp32, batch 8, Nesterov) 2 steps on the card
    and on the CPU from the same weights and batches; ResNet-50 at full
    width in bf16 (batch 4): the training forward and its loss on both."""
    import torch
    from theanompi_tpu_torch import bridge
    from theanompi_tpu_torch.models.model_zoo.resnet50 import ResNet50
    from theanompi_tpu_torch.models.model_zoo.wrn import WRN
    from theanompi_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from theanompi_tpu_torch.train import init_train_state, make_train_step
    from theanompi_tpu_torch.tree import tree_leaves, tree_map

    recipe = WRN.default_recipe().replace(
        batch_size=8, sched_kwargs={"lr": 0.01, "boundaries": [60, 120, 160], "factor": 0.2})
    model = WRN(recipe)
    rng = torch.Generator().manual_seed(3)
    xs = [torch.randn(8, 32, 32, 3, generator=rng) for _ in range(2)]
    ys = [torch.randint(0, 10, (8,), generator=rng) for _ in range(2)]
    out = {}
    for d in ("cpu", dev):
        state = init_train_state(model, torch.Generator().manual_seed(7), d)
        before = [p.detach().cpu().clone() for p in tree_leaves(state.params)]
        reset_launch_counts()
        with torch.no_grad():
            logits, stats0 = model.apply(state.params, state.model_state, xs[0].to(d),
                                         train=True)
        stats0 = [s.cpu() for s in tree_leaves(stats0)]
        step = make_train_step(model, fused_update=True)
        losses = []
        for x, y in zip(xs, ys):
            state, m = step(state, x.to(d), y.to(d), None)
            losses.append(float(m["loss"]))
        after = [p.detach().cpu() for p in tree_leaves(state.params)]
        out[str(d)] = (losses, logits.cpu(), stats0, [a - b for a, b in zip(after, before)],
                       [v.detach().cpu() for v in tree_leaves(state.opt_state["vel"])],
                       [s.cpu() for s in tree_leaves(state.model_state)], launch_counts())
    (lc, oc, s0c, dc, vc, sc, kc), (lg, og, s0g, dg, vg, sg, kg) = out["cpu"], out[str(dev)]
    check(not any(kc.values()), f"the CPU run launched kernels: {kc}")
    n_leaves = len(dc)
    check({k: v for k, v in kg.items() if v} == {"fused_momentum": update_launches(n_leaves) * 2},
          f"the card run launched {kg}")
    logit_x = _rel_excess(og, oc, 1e-4, 1e-4 * oc.abs().max().item())
    stats_x = max(_rel_excess(a, b, 1e-4, 1e-4 * b.abs().max().item()) for a, b in zip(s0g, s0c))
    paths = [k[1:] for k, _ in bridge._paths(state.params, "")]

    def worst(cpu, card):
        r = [((a - b).norm() / a.norm()).item() for a, b in zip(cpu, card)]
        return max(r), r.index(max(r))

    (rp, ip), (rv, iv), (rs, _) = worst(dc, dg), worst(vc, vg), worst(sc, sg)
    rel = {"parameter change": rp, "velocity": rv, "BN statistics": rs}
    limits = {"parameter change": 1e-1, "velocity": 1e-1, "BN statistics": 1e-3}
    print(f"[zoo-parity] wrn-28-10 fp32: logits x{logit_x:.3g} of rtol 1e-4 + 1e-4 max, the BN "
          f"statistics of that forward x{stats_x:.3g}; losses card {lg} vs CPU {lc}; after 2 "
          f"steps, worst leaf ||card - CPU|| / ||CPU|| {rel} (limits {limits}; worst change "
          f"{paths[ip]}, worst velocity {paths[iv]})", flush=True)
    check(logit_x <= 1, f"wrn card logits differ from the CPU's (x{logit_x:.3g})")
    check(stats_x <= 1, f"wrn card BN statistics differ from the CPU's (x{stats_x:.3g})")
    check(all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(lc, lg)),
          f"wrn card losses {lg} vs CPU {lc}")
    check(all(rel[k] <= limits[k] for k in rel), f"wrn card trajectory differs: {rel}")
    result = {"wrn": {"logit_excess": logit_x, "stats_excess": stats_x, "rel_norm": rel,
                      "losses": {"card": lg, "cpu": lc}, "launches": kg}}

    # ResNet-50, bf16: each top-level layer fed the CPU's own input of that
    # layer (bf16 limit), then the whole forward, whose rounding the
    # network amplifies, against the CPU's own spread under a one-ulp
    # (2^-8) change of its input (the worst of 3 seeded draws)
    model = ResNet50(ResNet50.default_recipe().replace(batch_size=4))
    rng = torch.Generator().manual_seed(5)
    x = torch.randn(4, *model.recipe.input_shape, generator=rng)
    y = torch.randint(0, model.recipe.num_classes, (4,), generator=rng)
    params, st = model.init_tree(torch.Generator().manual_seed(7))
    on_card = tree_map(lambda t: t.to(dev), params), tree_map(lambda t: t.to(dev), st)
    net = model.net
    worst_layer, worst_name = 0.0, None
    with torch.no_grad():
        h = x.to(torch.bfloat16)
        for key, layer in zip(net._keys, net.layers):
            out_c, st_c = layer.apply(params.get(key, {}), st.get(key, {}), h, train=True)
            out_g, st_g = layer.apply(on_card[0].get(key, {}), on_card[1].get(key, {}),
                                      h.to(dev), train=True)
            for a, b in zip([out_g, *tree_leaves(st_g)], [out_c, *tree_leaves(st_c)]):
                d = ((a.float().cpu() - b.float()).abs().max() / b.float().abs().max()).item()
                if d > worst_layer:
                    worst_layer, worst_name = d, key
            h = out_c
        res = {}
        ulp = [("cpu-ulp", x * (1 + 2.0 ** -8 * (2 * torch.randint(
            0, 2, x.shape, generator=torch.Generator().manual_seed(s)) - 1)), "cpu")
            for s in (11, 12, 13)]
        for label, xx, d in (("cpu", x, "cpu"), ("card", x, dev), *ulp):
            p_, s_ = (params, st) if d == "cpu" else on_card
            logits, _ = model.apply(p_, s_, xx.to(d), train=True)
            res.setdefault(label, []).append((logits.float().cpu(),
                                              float(model.loss(logits, y.to(d)))))
    [(oc, lc)], [(og, lg)] = res["cpu"], res["card"]
    share = ((og - oc).abs().max() / oc.abs().max()).item()
    draws = [((ou - oc).abs().max() / oc.abs().max()).item() for ou, _ in res["cpu-ulp"]]
    control = max(draws)
    print(f"[zoo-parity] resnet50 bf16, batch 4: each layer fed the CPU's input, card - CPU "
          f"at most {worst_layer:.4g} of the output's or statistics' largest value ({worst_name}; "
          f"limit 2^-5); the whole forward's logits card - CPU {share:.4g} of their largest "
          f"value, the CPU's own under a one-ulp input change {draws} (limit 1x the worst); "
          f"loss card {lg} vs CPU {lc} (rtol 2e-2)", flush=True)
    check(worst_layer <= 2.0 ** -5, f"resnet50 bf16 layer {worst_name} differs by "
                                    f"{worst_layer:.4g} of max")
    check(0 < control and share <= control,
          f"resnet50 bf16 logits differ by {share:.4g} of max, beyond the CPU's own "
          f"{control:.4g} (worst of {draws})")
    check(math.isclose(lg, lc, rel_tol=2e-2), f"resnet50 bf16 loss {lg} vs {lc}")
    result["resnet50"] = {"layer_share": worst_layer, "logit_share": share,
                          "logit_control": control, "loss": {"card": lg, "cpu": lc}}
    return result


# tools/bench.py of the new models (--fused-update): steps a call; 3 timed calls each
ZOO_BENCH = {"wrn": 5, "resnet50": 5, "vgg16": 5}


def phase_zoo_bench():
    """``tools/bench.py`` of WRN-28-10, ResNet-50 and VGG16 (--fused-update),
    eager and captured; their last losses must agree."""
    import gc

    import torch
    from theanompi_tpu_torch.tools.bench import bench_compute

    out = {}
    for name, steps in ZOO_BENCH.items():
        pair = {}
        for mode in ("eager", "captured"):
            gc.collect()
            torch.cuda.empty_cache()
            pair[mode] = bench_compute(name, steps=steps, trials=3, eager=mode == "eager",
                                       fused_update=True)
            print(f"[zoo] bench {json.dumps(pair[mode])}", flush=True)
        check(pair["captured"]["captured"] and not pair["eager"]["captured"]
              and pair["captured"]["last_losses"] == pair["eager"]["last_losses"],
              f"zoo bench {name}: captured {pair['captured']['last_losses']} vs eager "
              f"{pair['eager']['last_losses']}")
        out[name] = pair
    return out


def only_bsp_exchange(smi: str, kind: str, t_start: float) -> int:
    """``--only bsp-exchange``: build the phase's kernels (the fused
    update and the quantizer) and run phase bsp-exchange alone, on every
    card there is; its JSON, the card line and the result line last."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from theanompi_tpu_torch.ops import fused_update as fu
    from theanompi_tpu_torch.ops import quant as tq

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            for src, f in (("fused_update.cu", pool.submit(fu.build)),
                           ("quant.cu", pool.submit(tq.build))):
                print(f"[build] csrc/{src}: nvcc {f.result():.2f} s", flush=True)
        exchange = phase_bsp_exchange(torch.cuda.device_count())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"bsp_exchange": exchange}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def only_rules(smi: str, kind: str, t_start: float) -> int:
    """``--only rules``: build the phase's kernels (the fused update and
    the quantizer) and run phase rules alone, on every card there is; its
    JSON, the card line and the result line last."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from theanompi_tpu_torch.ops import fused_update as fu
    from theanompi_tpu_torch.ops import quant as tq

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            for src, f in (("fused_update.cu", pool.submit(fu.build)),
                           ("quant.cu", pool.submit(tq.build))):
                print(f"[build] csrc/{src}: nvcc {f.result():.2f} s", flush=True)
        rules = phase_rules(torch.cuda.device_count(), smi)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"rules": rules}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def only_resume(smi: str, kind: str, t_start: float) -> int:
    """``--only resume``: build the phase's kernels (the fused update and
    the quantizer) and run phase resume alone; on 4 cards only its NCCL
    shrink from 4 ranks to 2 (the one-card and gloo runs need one card);
    its JSON, the card line and the result line last."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from theanompi_tpu_torch.ops import fused_update as fu
    from theanompi_tpu_torch.ops import quant as tq

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            for src, f in (("fused_update.cu", pool.submit(fu.build)),
                           ("quant.cu", pool.submit(tq.build))):
                print(f"[build] csrc/{src}: nvcc {f.result():.2f} s", flush=True)
        t0 = time.perf_counter()
        n = torch.cuda.device_count()
        resume = phase_resume(n, nccl_only=n >= 4)
        print(f"[resume] done ({time.perf_counter() - t0:.1f} s)", flush=True)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"resume": resume}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def only_scaling(smi: str, kind: str, t_start: float) -> int:
    """``--only scaling``: phase scaling alone on every card there is (4:
    NCCL at 1, 2 and 4 ranks, flat psum against hier over 2 slices); its
    JSON, the card line and the result line last. The probe launches no
    kernel of the port, so nothing is built."""
    import torch

    try:
        scaling = phase_scaling(torch.cuda.device_count())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"scaling": scaling}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def only_sp(smi: str, kind: str, t_start: float) -> int:
    """``--only sp``: build the flash kernels and run phase sp's 4-card
    part (``phase_sp4``) on 4 cards over NCCL; its JSON, the card line
    and the result line last."""
    import torch

    from theanompi_tpu_torch.ops import flash_attention as fa

    try:
        print(f"[build] csrc/flash_attention.cu: nvcc {fa.build():.2f} s", flush=True)
        t0 = time.perf_counter()
        sp4 = phase_sp4(*successor_table(), torch.cuda.device_count())
        print(f"[sp4] done ({time.perf_counter() - t0:.1f} s)", flush=True)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"sp": sp4}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def only_tp(smi: str, kind: str, t_start: float) -> int:
    """``--only tp``: build the flash kernels and the quantizer and run
    phase tp's 4-card part (``phase_tp4``) on 4 cards over NCCL; its JSON,
    the card line and the result line last."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from theanompi_tpu_torch.ops import flash_attention as fa
    from theanompi_tpu_torch.ops import quant as tq

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = {"flash_attention.cu": pool.submit(fa.build), "quant.cu": pool.submit(tq.build)}
            for src, f in futs.items():
                print(f"[build] csrc/{src}: nvcc {f.result():.2f} s", flush=True)
        t0 = time.perf_counter()
        tp4 = phase_tp4(*successor_table(), torch.cuda.device_count())
        print(f"[tp4] done ({time.perf_counter() - t0:.1f} s)", flush=True)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "tp4.json"), "w") as f:
            json.dump({"tp": tp4, "card": smi}, f, default=str)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"tp": tp4}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def build_all():
    """Build every kernel library at once (one nvcc per source, started
    together); returns {source: nvcc seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    from theanompi_tpu_torch.ops import flash_attention as fa
    from theanompi_tpu_torch.ops import fused_update as fu
    from theanompi_tpu_torch.ops import pool as tp
    from theanompi_tpu_torch.ops import quant as tq

    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = {"fused_update.cu": pool.submit(fu.build), "quant.cu": pool.submit(tq.build),
                "flash_attention.cu": pool.submit(fa.build), "pool.cu": pool.submit(tp.build)}
        return {src: f.result() for src, f in futs.items()}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = sys.argv[1:] if argv is None else list(argv)
    only = None
    if args:
        if len(args) != 2 or args[0] != "--only" or args[1] not in (
                "bsp-exchange", "rules", "resume", "scaling", "sp", "tp"):
            print("usage: python3 chip_smoke.py [--only bsp-exchange|rules|resume|scaling|sp|tp]",
                  file=sys.stderr)
            return 2
        only = args[1]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "theanompi_tpu_torch")):
        print("chip_smoke: theanompi_tpu_torch/ not found beside this script; run it "
              "from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    stack = contextlib.ExitStack()
    try:
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        check(kind in CARD_RATES, f"no data-sheet rates for {kind!r} (known: {sorted(CARD_RATES)}); "
                                  "add the card's memory rate and peaks to CARD_RATES")
        mem_rate, fp32_peak, bf16_peak, tf32_peak = CARD_RATES[kind]
        print(f"card: {smi} | {kind} | memory rate for bounds {mem_rate / 1e12:.2f} TB/s", flush=True)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        # the feed phases' ImageNet shards, removed at exit
        shard_dir = stack.enter_context(tempfile.TemporaryDirectory(prefix="tmpi-shards-"))

        from theanompi_tpu_torch.ops.kernels import library_path

        if only == "bsp-exchange":
            return only_bsp_exchange(smi, kind, t_start)
        if only == "rules":
            return only_rules(smi, kind, t_start)
        if only == "resume":
            return only_resume(smi, kind, t_start)
        if only == "scaling":
            return only_scaling(smi, kind, t_start)
        if only == "sp":
            return only_sp(smi, kind, t_start)
        if only == "tp":
            return only_tp(smi, kind, t_start)
        t0 = time.perf_counter()
        builds = build_all()
        for src, secs in builds.items():
            print(f"[build] csrc/{src} -> {library_path(src).name}: nvcc {secs:.2f} s", flush=True)
        print(f"[build] phase wall {time.perf_counter() - t0:.2f} s", flush=True)
        sass = phase_sass()
        ptxas = ptxas_report()
        ptxas_codec = ptxas_report("quant.cu", codec_label, 3)
        ptxas_pool = ptxas_report("pool.cu", pool_label, 8)

        from theanompi_tpu_torch.tools.update_variants import leaf_specs

        shapes = alexnet_leaf_shapes()
        check(len(shapes) == 16 and sum(math.prod(s) for s in shapes) == 60_965_224,
              f"unexpected AlexNet leaves {shapes}")
        leaf_sets = [("alexnet", leaf_specs("alexnet")), ("googlenet", leaf_specs("googlenet"))]
        check([s for s, _ in leaf_sets[0][1]] == shapes and len(leaf_sets[1][1]) == 128,
              f"unexpected leaves: AlexNet {leaf_sets[0][1]}, GoogLeNet {len(leaf_sets[1][1])}")
        # the zoo's main paths give the kernel these leaf sets too (WRN-28-10 Nesterov)
        zoo_sets = [(name, leaf_specs(name)) for name in ("wrn", "resnet50", "vgg16")]
        check([len(specs) for _, specs in zoo_sets] == [80, 161, 32],
              f"unexpected zoo leaves: {[(n, len(s)) for n, s in zoo_sets]}")
        t0 = time.perf_counter()
        worst, worst_ulp, update_plans = phase_kernels(leaf_sets + zoo_sets, dev)
        print(f"[kernels] all cases match ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        worst_q, n_quant_cases = phase_quant(shapes, dev)
        print(f"[quant] {n_quant_cases} cases bit-identical ({time.perf_counter() - t0:.1f} s)",
              flush=True)

        t0 = time.perf_counter()
        worst_f, flash_readings = phase_flash(dev)
        print(f"[flash] {len(flash_cases())} cases within tolerance ({time.perf_counter() - t0:.1f} s)",
              flush=True)

        t0 = time.perf_counter()
        worst_p, n_pool_cases, pool_control = phase_pool(dev)
        print(f"[pool] {n_pool_cases} cases bit-identical, control refused "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        feed = phase_feed(dev, shard_dir)
        print(f"[feed] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        runs = phase_main()
        print(f"[main] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        lm_run = phase_lm_main()
        print(f"[lm-main] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        lm350_run = phase_lm350_main()
        print(f"[lm350-main] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        nd_ranks = spawn_nd_ranks(*successor_table())
        print(f"[sp/tp] ranks done ({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        sp_runs = phase_sp(nd_ranks)
        print(f"[sp] done ({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        tp_runs = phase_tp(nd_ranks, next(iter(sp_runs.values()))["one_rank_first_loss"])
        print(f"[tp] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        gnet_runs = phase_googlenet_main()
        print(f"[googlenet-main] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        feed_runs = phase_feed_main(shard_dir)
        print(f"[feed-main] done ({time.perf_counter() - t0:.1f} s)", flush=True)
        print("[feed] " + json.dumps({
            "host_batch_ms": {k: {m: f[m] for m in ("gather_ms", "crop_ms", "pin_ms",
                                                    "host_batch_ms", "h2d_ms")}
                              for k, f in feed["feeds"].items() if "host_batch_ms" in f},
            "gather_and_crop_ms": {k: feed["feeds"][k]
                                   for k in ("gather_float32", "gather_int32", "crop")},
            "cli": {k: {"step_ms": r["summary"]["step_ms"],
                        "resident_step_ms": r["resident_step_ms"],
                        "cli_over_resident": r["cli_over_resident"],
                        "feed_wait_ms": r["summary"]["feed_wait_ms_per_rank"][0],
                        "images_per_sec": r["summary"]["images_per_sec"]}
                    for k, r in feed_runs.items()}}), flush=True)

        t0 = time.perf_counter()
        e2e = phase_e2e()
        print(f"[e2e] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        rank_runs = phase_bsp_ranks(torch.cuda.device_count())
        print(f"[bsp-ranks] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        scaling = phase_scaling(torch.cuda.device_count())
        print(f"[scaling] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        exchange = phase_bsp_exchange(torch.cuda.device_count())
        print(f"[bsp-exchange] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        rules = phase_rules(torch.cuda.device_count(), smi)
        print(f"[rules] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        # the 2 ranks' same-world sharded crash runs under --only resume
        resume_runs = phase_resume(torch.cuda.device_count(), sharded_crash=False)
        print(f"[resume] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        phase_parity(dev)
        print(f"[parity] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        lm_parity_launches = phase_lm_parity(dev)
        print(f"[lm-parity] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        remat = phase_remat_parity(dev)
        print(f"[remat-parity] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        gnet_parity = phase_googlenet_parity(dev)
        print(f"[googlenet-parity] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        graph_runs_ = phase_graph()
        print(f"[graph] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        zoo_runs = phase_zoo_main()
        print(f"[zoo-main] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        zoo_parity = phase_zoo_parity(dev)
        print(f"[zoo-parity] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        zoo_bench = phase_zoo_bench()
        print(f"[zoo-bench] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        times = phase_times(leaf_sets, dev, mem_rate, fp32_peak)
        times.update(phase_quant_times(dev, mem_rate, fp32_peak))
        times.update(phase_flash_times(dev, mem_rate, fp32_peak, bf16_peak))
        times.update(phase_flash_times_fp32(dev, mem_rate, fp32_peak, tf32_peak))
        times.update(phase_pool_times(dev, mem_rate, fp32_peak))
        print(f"[times] done ({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.synchronize()
        # last: a failed capture leaves its stream's pool to the process
        phase_capture_failure(dev)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        stack.close()

    codec_run = rank_runs["psum+int8:ef"]
    src_fu = "theanompi_tpu_torch/csrc/fused_update.cu"
    src_q = "theanompi_tpu_torch/csrc/quant.cu"
    kernels = []
    for name, replaces in (("fused_momentum", "theanompi_tpu/ops/pallas_update.py:78"),
                           ("fused_sgd", "theanompi_tpu/ops/pallas_update.py:90")):
        t, tg = times[(name, "alexnet")], times[(name, "googlenet")]
        rule = "sgd" if name == "fused_sgd" else "momentum"
        kernels.append({
            "name": name, "route": "cuda", "source": src_fu, "replaces": replaces,
            "launches": runs[name]["launches"], "max_abs_err": worst[name],
            "ms": t["step_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "matched": True,
            "tolerance": "fp32 params and velocity bit-identical; bf16 params <= 1 ulp "
                         f"(worst seen {worst_ulp})",
            "work": ("one optimizer step over AlexNet's 16 fp32 leaves (60,965,224 params), "
                     f"{t['launches']} multi-tensor launch"),
            "turns_ms": t["turns_ms"],
            "per_leaf_launches_ms": t["per_leaf_ms"],
            "host_us_per_apply": t["host_us_per_apply"],
            "table_built_ms": t["table_built_ms"],
            "googlenet_step": {k: tg[k] for k in ("step_ms", "table_built_ms", "per_leaf_ms",
                                                  "library_ms", "plain_ms", "bound_ms", "launches",
                                                  "turns_ms", "host_us_per_apply")},
            "ptxas": {k: v for k, v in ptxas.items() if k.startswith(rule)},
            "launches_checked": update_plans,
            "library_note": (
                "torch.optim.SGD(momentum=0.9, weight_decay=5e-4, fused=True).step(): "
                "same class of rule, velocity parametrised differently (v=mu*v+g; p-=lr*v)"
                if name == "fused_momentum" else
                "torch.optim.SGD(momentum=0, weight_decay=5e-4, fused=True).step(): same function"
            ),
            "launches_in": (f"the {MAIN_STEPS}-step AlexNet run through the CLI" if rule ==
                            "momentum" else f"the {SGD_STEPS}-step AlexNet sgd run"),
            "main_path_step_ms": runs[name]["summary"]["step_ms"],
            "main_path_images_per_sec": runs[name]["summary"]["images_per_sec"],
        })
        if rule == "momentum":
            # the same run at --dispatch-depth 1 and the default, in turns
            kernels[-1]["dispatch_depth_runs"] = runs["dispatch"]
            # phase e2e: AlexNet from shards through run_training, each depth's run
            kernels[-1]["e2e_launches"] = {
                f"depth {row['dispatch_depth']}": row["kernel_launches"][name]
                for row in e2e["dispatch_sweep"]}
        if rule == "momentum":
            kernels[-1]["googlenet_main_launches"] = gnet_runs["pool-kernel"]["launches"][name]
            kernels[-1]["feed_main"] = {k: {"launches": r["launches"][name],
                                            "step_ms": r["summary"]["step_ms"],
                                            "resident_step_ms": r["resident_step_ms"]}
                                        for k, r in feed_runs.items()}
            # the zoo's runs through the CLI (WRN-28-10 with nesterov=1)
            zoo_cli_runs = {"wrn-eager": zoo_runs["wrn"]["eager"],
                            "wrn-captured": zoo_runs["wrn"]["captured"],
                            **{f"wrn-{k}": v for k, v in zoo_runs["wrn_resume"].items()},
                            **{k: zoo_runs[k] for k in ("resnet50", "vgg16", "cifar10", "mlp")}}
            kernels[-1]["zoo_main"] = {k: {"launches": r["launches"][name],
                                           "step_ms": r["summary"]["step_ms"],
                                           "images_per_sec": r["summary"]["images_per_sec"],
                                           "peak_memory_bytes": r["peak_bytes"]}
                                       for k, r in zoo_cli_runs.items()}
            kernels[-1]["zoo_parity_launches"] = zoo_parity["wrn"]["launches"][name]
            kernels[-1]["rules_launches_per_rank"] = rules_launches(rules, name)
            kernels[-1]["zoo_bench"] = {k: {m: {f: b[m][f] for f in ("step_ms", "value", "mfu")}
                                            for m in b} for k, b in zoo_bench.items()}
    no_library = ("no single PyTorch call computes an absmax-scaled int8 quantize: "
                  "torch.quantize_per_tensor takes the scale as an input and multiplies by "
                  "its reciprocal")
    for name, replaces, launches in (
        ("quant_block", "theanompi_tpu/ops/pallas_quant.py:114", codec_run["launches"]["quant_block"]),
        ("dequant_block", "theanompi_tpu/ops/pallas_quant.py:125",
         codec_run["launches"]["dequant_block"]),
        ("quant", "theanompi_tpu/ops/pallas_quant.py:46", 0),
        ("dequant", "theanompi_tpu/ops/pallas_quant.py:55", 0),
    ):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src_q, "replaces": replaces,
            "launches": launches, "max_abs_err": worst_q[name],
            "ms": t["step_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "turns_ms": t["turns_ms"],
            "matched": True, "tolerance": "bit-identical (a NaN matches any NaN)",
            "work": ("one codec round over AlexNet's 16 leaves in one multi-leaf launch "
                     "(tails zero-padded in the kernel)" if "per_leaf_ms" in t else
                     "one codec round over AlexNet's 16 leaves, each padded to (rows, 128), "
                     "a launch each"),
            "library_note": (
                no_library if t["library_ms"] is None else
                "torch.mul(int8 vals (R, 128), f32 scales (R, 1), out=) over the round's "
                "buffers in one call: the same function (per leaf: library_per_leaf_ms)"
                if "library_per_leaf_ms" in t else
                "torch.mul(int8 vals, f32 scales) per leaf: the same function"),
            "launches_in": (f"the {codec_run['n']}-rank psum + int8:ef run, all ranks, "
                            f"{RANK_STEPS} steps" if launches else
                            "not on the main path (whole-buffer scale; tests only)"),
        })
        if launches:
            kernels[-1]["rules_launches_per_rank"] = rules_launches(rules, name)
            # phase sp's codec run: each rank's launches (one a step)
            kernels[-1]["sp_launches_per_rank"] = {
                k_: v_["launches"].get(name, 0) for k_, v_ in sp_runs.items()}
            # phase tp's: one a step over the replicated leaves
            kernels[-1]["tp_launches_per_rank"] = {
                k_: v_["launches"].get(name, 0) for k_, v_ in tp_runs.items()}
        if "per_leaf_ms" in t:
            kernels[-1].update(table_built_ms=t["table_built_ms"],
                               one_leaf_calls_ms=t["per_leaf_ms"],
                               host_us_per_round=t["host_us_per_round"],
                               ptxas={k: v for k, v in ptxas_codec.items()
                                      if (k == "quantize") == (name == "quant_block")})
        if "library_per_leaf_ms" in t:
            kernels[-1]["library_per_leaf_ms"] = t["library_per_leaf_ms"]
        if name == "quant":
            # the card's own time over one buffer of the round's elements, one
            # launch, in turns with the three-pass launcher it replaced (the
            # 16-call round beside it)
            one = times["quant_one_buffer"]
            kernels[-1].update(
                {k_: one[k_] for k_ in ("plain_ms", "bound_ms", "bound_by", "turns_ms",
                                        "two_read_floor_ms")},
                ms=one["step_ms"], old_kernel_ms=one["three_pass_ms"],
                work=(f"one launch over one ({one['rows']}, 128) buffer, the codec round's "
                      f"{one['elements']} elements (the three-pass launcher it replaced in "
                      "the same turns: old_kernel_ms; two_read_floor_ms: the input read twice "
                      "and the values written once)"),
                round_of_16_calls={k_: t[k_] for k_ in ("step_ms", "plain_ms", "bound_ms",
                                                        "library_ms", "turns_ms")})
        if name == "dequant":
            # the card's own time: one launch over one buffer of the round's
            # elements against one torch.mul (the 16-call round beside it)
            one = times["dequant_one_buffer"]
            kernels[-1].update(
                {k_: one[k_] for k_ in ("plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "turns_ms")},
                ms=one["step_ms"], work=(f"one launch over one ({one['rows']}, 128) buffer, the "
                                         f"codec round's {one['elements']} elements"),
                library_note="torch.mul(int8 vals, f32 (1, 1) scale): the same function",
                round_of_16_calls={k_: t[k_] for k_ in ("step_ms", "plain_ms", "bound_ms",
                                                        "library_ms", "turns_ms")})
    src_fa = "theanompi_tpu_torch/csrc/flash_attention.cu"
    lm = lm_run["summary"]
    for name, replaces in (
        ("flash_fwd_sm90", "theanompi_tpu/ops/pallas_attention.py:131"),
        ("flash_fwd", "theanompi_tpu/ops/pallas_attention.py:131"),
        ("flash_dq_sm90", "theanompi_tpu/ops/pallas_attention.py:174 + :264"),
        ("flash_dq", "theanompi_tpu/ops/pallas_attention.py:174 + :264"),
        ("flash_dkv_sm90", "theanompi_tpu/ops/pallas_attention.py:207 + :302"),
        ("flash_dkv", "theanompi_tpu/ops/pallas_attention.py:207 + :302"),
    ):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src_fa, "replaces": replaces,
            "launches": lm_run["launches"][name], "max_abs_err": worst_f[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "matched": True,
            "tolerance": ("fp32: o rtol 1e-5 + 1e-6 max|o|, dq/dk/dv rtol 1e-4 + 1e-5 max; bf16: "
                          "o <= 1 bf16 ulp + 2^-9 sum_i p_i |v_i| / l (a p rounded to its "
                          "bf16 neighbour on one side), dq/dk rtol 1e-4 + 2^-9 max (a flipped "
                          "bf16 rounding of ds), dv (fp32 product, p unrounded; in "
                          "flash_dkv_sm90 three exact bf16 products of p's parts) rtol 1e-4 + "
                          "1e-5 max; lse atol 1e-5"),
            "bf16_worst_share_of_tolerance": {k_: v_ for k_, v_ in flash_readings.items()
                                              if k_ != "dv_control"},
            "bf16_dv_control_share": flash_readings["dv_control"],
            "work": ("one launch at the 136M LM's attention shape: BH 96, T 1024, D 64, bf16, "
                     "causal" + (f" (the generic kernel's bf16 instantiation, which the LM ran "
                                 f"before {name}_sm90)" if name in GENERIC_FLASH else "")),
            "library_note": (
                "torch.nn.functional.scaled_dot_product_attention(is_causal=True) " +
                ("forward" if name.startswith("flash_fwd") else
                 "backward, dq, dk and dv in one call (the same number for every dq "
                 "and dk/dv kernel)") +
                ": not the same function (its dv product is bf16, its blocks its own); a "
                "yardstick only, the port never calls it"),
            "launches_in": (f"the {LM_STEPS}-step TransformerLM_136M run through the CLI "
                            f"({LM_LAYERS} layers; the forward also in 1 validation batch)" +
                            ("; no route takes this kernel since flash_fwd_mma_bf16 (held to "
                             "the same limits in phase flash through its own launcher)"
                             if name == "flash_fwd" else
                             "; no route takes this kernel since flash_dq_mma (fp32) and "
                             "flash_dq_mma_bf16 (bf16 heads with D % 8 != 0); held to the same "
                             "limits in phase flash through its own launcher (fp32 and bf16)"
                             if name == "flash_dq" else
                             "; no route takes this kernel since flash_dkv_mma (fp32) and "
                             "flash_dkv_mma_bf16 (bf16 heads with D % 8 != 0); held to the same "
                             "limits in phase flash through its own launcher"
                             if name == "flash_dkv" else "")),
            "main_path_step_ms": lm["step_ms"],
            "main_path_tokens_per_sec": lm_run["tokens_per_sec"],
            # the remat LMs: TransformerLM_350M's 4 steps + 1 val batch
            # (the forward twice a layer a step) and phase remat-parity's
            "lm350_launches": lm350_run["launches"][name],
            "lm350_step_ms": lm350_run["summary"]["step_ms"],
            "lm350_tokens_per_sec": lm350_run["tokens_per_sec"],
            "remat_parity_launches": {k_: v_.get(name, 0)
                                      for k_, v_ in remat["launches"].items()},
            # phase sp: each rank's launches, 2 gloo ranks at --sp 2 (2 layers)
            "sp_launches_per_rank": {k_: v_["launches"].get(name, 0)
                                     for k_, v_ in sp_runs.items()},
            # phase tp: each rank's launches, 2 gloo ranks at --tp 2 (2 layers)
            "tp_launches_per_rank": {k_: v_["launches"].get(name, 0)
                                     for k_, v_ in tp_runs.items()},
        })
        if t.get("turns_ms"):
            kernels[-1]["turns_ms"] = t["turns_ms"]
        if name in GENERIC_FLASH:  # its fp32 instantiation at the same shape, and bf16 at D 60
            kernels[-1]["fp32"] = times[f"{name}_fp32"]
            kernels[-1]["bf16_d60"] = times[f"{name}_d60"]
            kernels[-1]["lm_parity_launches"] = {run: c[name]
                                                 for run, c in lm_parity_launches.items()}
        if name == "flash_fwd_sm90":
            kernels[-1].update(design="TMA-fed 2-stage K/V ring, wgmma for QK^T "
                               "and PV (P from registers), 128-row Q tiles heaviest first",
                               sass=sass["flash_fwd_sm90_kernel"])
        if name == "flash_dq_sm90":
            kernels[-1].update(design="Q and dO once per 128-query CTA, TMA-fed 2-stage K/V "
                               "ring, wgmma for S = Q K^T and dP = dO V^T (p while dP is in "
                               "flight) and dQ += dS K (dS from registers, K read MN-major), "
                               "query tiles heaviest first",
                               sass=sass["flash_dq_sm90_kernel"])
        if name == "flash_dkv_sm90":
            kernels[-1].update(design="K/V once per 128-key CTA, TMA-fed 2-stage Q/dO ring, "
                               "wgmma for S^T = K Q^T, dP^T = V dO^T, dK += dS^T Q and dV += "
                               "P^T dO with p split into three exact bf16 parts (P and dS "
                               "from registers), key tiles heaviest first",
                               sass=sass["flash_dkv_sm90_kernel"])
    t = times["flash_fwd_mma"]
    kernels.append({
        "name": "flash_fwd_mma", "route": "cuda", "source": src_fa,
        "replaces": "theanompi_tpu/ops/pallas_attention.py:131",
        "launches": lm_run["launches"]["flash_fwd_mma"], "max_abs_err": worst_f["flash_fwd_mma"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "turns_ms": t["turns_ms"],
        "old_kernel_turns_ms": times["flash_fwd_fp32"]["turns_ms"],
        "matched": True,
        "tolerance": "fp32: o rtol 1e-5 + 1e-6 max|o|, lse atol 1e-5 (phase flash's fp32 limits)",
        "work": ("one launch at the 136M LM's attention shape in fp32: BH 96, T 1024, D 64, "
                 "causal; products as three tf32 products each (38.69 GFLOP at the tf32 peak)"),
        "library_note": (
            f"torch.nn.functional.scaled_dot_product_attention(is_causal=True) forward in fp32 "
            f"(backend {t['sdpa_backend']}, kernels {t['sdpa_kernels']}); max |o - o_float64| "
            f"{t['float64_max_abs_err']}: a yardstick only, the port never calls it"),
        "launches_in": (f"fp32 attention: {lm_parity_launches['fp32']['flash_fwd_mma']} launches "
                        "in phase lm-parity (a 2-layer fp32 LM, 2 steps); the main path's LM is "
                        "bf16 (flash_fwd_sm90)"),
        "lm_parity_launches": lm_parity_launches["fp32"]["flash_fwd_mma"],
        "design": ("a CTA of 8 warps a (128-row Q tile, b*h), heaviest first; Q once into "
                   "registers as tf32 hi/lo fragments; a 2-stage cp.async K/V ring, each tile "
                   "split into tf32 hi/lo once by the CTA (V transposed); S = Q K^T and P V as "
                   "mma.sync m16n8k8 tf32, each product three (3xTF32); S, P, acc, m, l in "
                   "registers (permuted columns make P's C fragment the A fragment); masks "
                   "only on diagonal and ragged tiles"),
        "sass": sass["flash_fwd_mma_kernel"],
    })
    t = times["flash_fwd_mma_bf16"]
    n_bf16 = lm_parity_launches["bf16_d60"]["flash_fwd_mma_bf16"]
    kernels.append({
        "name": "flash_fwd_mma_bf16", "route": "cuda", "source": src_fa,
        "replaces": "theanompi_tpu/ops/pallas_attention.py:131",
        "launches": n_bf16, "max_abs_err": worst_f["flash_fwd_mma_bf16"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "turns_ms": t["turns_ms"],
        "old_kernel_turns_ms": times["flash_fwd_d60"]["turns_ms"],
        "matched": True,
        "tolerance": ("bf16: o <= 1 bf16 ulp + 2^-9 sum_i p_i |v_i| / l, lse atol 1e-5 (phase "
                      "flash's bf16 limits)"),
        "bf16_worst_share_of_tolerance": {k_: v_ for k_, v_ in flash_readings.items()
                                          if k_ != "dv_control"},
        "work": ("one launch at BH 96, T 1024, D 60, bf16, causal (heads of no whole 16-byte "
                 "rows, which the tensor maps of flash_fwd_sm90 refuse)"),
        "library_note": (
            f"torch.nn.functional.scaled_dot_product_attention(is_causal=True) forward at D 60 "
            f"(backend {t['sdpa_backend']}): a yardstick only, the port never calls it"),
        "launches_in": (f"phase lm-parity's bf16 LM with heads of 60 (d 120, 2 heads, 2 layers, "
                        f"2 steps): {n_bf16} launches; the main path's LM has heads of 64 "
                        "(flash_fwd_sm90)"),
        "design": ("a CTA of 8 warps a (128-row Q tile, b*h), heaviest first; Q once into "
                   "registers as bf16 A fragments; a 2-stage K/V ring by 4-byte cp.async (D "
                   "even) or register-staged loads (D odd); S = Q K^T and P V as mma.sync "
                   "m16n8k16 bf16 with K and V fragments by ldmatrix (V transposed by "
                   ".trans); S's C fragments packed to bf16 are P V's A fragments; masks only "
                   "on diagonal and ragged tiles"),
        "sass": {"cp.async": sass["flash_fwd_mma_bf16_kernelILb0E"],
                 "staged": sass["flash_fwd_mma_bf16_kernelILb1E"]},
    })
    for name, replaces, work, design in (
        ("flash_dq_mma_bf16", "theanompi_tpu/ops/pallas_attention.py:174 + :264",
         "S, dP and dQ, 18.1 GFLOP",
         "a CTA of 8 warps a (128-row Q tile, b*h), heaviest first; Q and dO once into "
         "registers as bf16 A fragments; the forward's 2-stage K/V ring (4-byte cp.async for "
         "D even, register-staged loads for D odd); S = Q K^T and dP = dO V^T as mma.sync "
         "m16n8k16 bf16 with K and V fragments by ldmatrix; dS rounded to bf16 from S's C "
         "fragments is dQ += dS K's A fragment, K's fragments by ldmatrix.trans; masks only on "
         "diagonal and ragged tiles"),
        ("flash_dkv_mma_bf16", "theanompi_tpu/ops/pallas_attention.py:207 + :302",
         "S^T, dP^T, dK and dV as three, 36.3 GFLOP",
         "a CTA of 8 warps a (128-key tile, b*h), heaviest first, a warp 16 keys x every "
         "query; K and V once into registers as bf16 A fragments; a 2-stage Q/dO ring (4-byte "
         "cp.async for D even, register-staged loads for D odd) with lse and dsum beside it; "
         "S^T = K Q^T and dP^T = V dO^T as mma.sync m16n8k16 bf16 (Q, dO fragments by "
         "ldmatrix), then per 16 queries P^T's C fragments split into hi, mid, lo as the A "
         "fragments of dV += P^T dO (three exact bf16 products) and dS^T's of dK += dS^T Q "
         "(dO, Q fragments by ldmatrix.trans)"),
    ):
        t = times[name]
        n_path = lm_parity_launches["bf16_d60"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src_fa, "replaces": replaces,
            "launches": n_path, "max_abs_err": worst_f[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "turns_ms": t["turns_ms"],
            "old_kernel_turns_ms": times[f"{name[:-9]}_d60"]["turns_ms"],
            "matched": True,
            "tolerance": ("bf16: dq/dk rtol 1e-4 + 2^-9 of the largest value, dv (p unrounded, "
                          "three exact bf16 products) rtol 1e-4 + 1e-5 of the largest value "
                          "(phase flash's bf16 limits)"),
            "bf16_worst_share_of_tolerance": {k_: v_ for k_, v_ in flash_readings.items()
                                              if k_ != "dv_control"},
            "work": (f"one launch at BH 96, T 1024, D 60, bf16, causal ({work} of bf16 products "
                     "over the causal half; heads of no whole 16-byte rows, which the tensor "
                     "maps of the sm90 kernels refuse)"),
            "library_note": (
                f"torch.nn.functional.scaled_dot_product_attention(is_causal=True) backward at "
                f"D 60 (dq, dk and dv in one call; backend {t['sdpa_backend']}): not the same "
                "function (its dv product is bf16), a yardstick only, the port never calls it"),
            "launches_in": (f"phase lm-parity's bf16 LM with heads of 60 (d 120, 2 heads, 2 "
                            f"layers, 2 steps): {n_path} launches; the main path's LM has heads "
                            "of 64 (the sm90 kernels)"),
            "design": design,
            "sass": {"cp.async": sass[f"{name}_kernelILb0E"],
                     "staged": sass[f"{name}_kernelILb1E"]},
        })
    t = times["flash_dq_mma"]
    n_dq = lm_parity_launches["fp32"]["flash_dq_mma"]
    kernels.append({
        "name": "flash_dq_mma", "route": "cuda", "source": src_fa,
        "replaces": "theanompi_tpu/ops/pallas_attention.py:174 + :264",
        "launches": n_dq, "max_abs_err": worst_f["flash_dq_mma"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "turns_ms": t["turns_ms"],
        "old_kernel_turns_ms": times["flash_dq_fp32"]["turns_ms"],
        "matched": True,
        "tolerance": "fp32: dq rtol 1e-4 + 1e-5 of the largest value (phase flash)",
        "work": ("one launch at the 136M LM's attention shape in fp32: BH 96, T 1024, D 64, "
                 "causal; three products as three tf32 products each (58.04 GFLOP at the tf32 "
                 "peak)"),
        "library_note": (
            f"torch.nn.functional.scaled_dot_product_attention(is_causal=True) backward in fp32 "
            f"(dq, dk and dv in one call; backend {t['sdpa_backend']}): not the same function, "
            "a yardstick only, the port never calls it"),
        "launches_in": (f"fp32 attention: {n_dq} launches in phase lm-parity (a 2-layer fp32 "
                        "LM, 2 steps); the main path's LM is bf16 (flash_dq_sm90)"),
        "lm_parity_launches": n_dq,
        "design": ("a CTA of 8 warps a (128-row Q tile, b*h), heaviest first; Q once into "
                   "registers as tf32 hi/lo fragments, dO's into shared memory in fragment "
                   "order; the forward's 2-stage cp.async K/V ring, each tile split into tf32 "
                   "hi/lo once by the CTA (K also transposed); S = Q K^T, dP = dO V^T and dQ += "
                   "dS K as mma.sync m16n8k8 tf32, each three products (3xTF32); permuted head "
                   "columns and key steps make dS's C fragment dQ's A fragment; masks only on "
                   "diagonal and ragged tiles"),
        "sass": sass["flash_dq_mma_kernel"],
    })
    t = times["flash_dkv_mma"]
    n_dkv = lm_parity_launches["fp32"]["flash_dkv_mma"]
    kernels.append({
        "name": "flash_dkv_mma", "route": "cuda", "source": src_fa,
        "replaces": "theanompi_tpu/ops/pallas_attention.py:207 + :302",
        "launches": n_dkv, "max_abs_err": worst_f["flash_dkv_mma"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "turns_ms": t["turns_ms"],
        "old_kernel_turns_ms": times["flash_dkv_fp32"]["turns_ms"],
        "matched": True,
        "tolerance": "fp32: dk and dv rtol 1e-4 + 1e-5 of the largest value (phase flash)",
        "work": ("one launch at the 136M LM's attention shape in fp32: BH 96, T 1024, D 64, "
                 "causal; four products as three tf32 products each (77.38 GFLOP at the tf32 "
                 "peak)"),
        "library_note": (
            f"torch.nn.functional.scaled_dot_product_attention(is_causal=True) backward in fp32 "
            f"(dq, dk and dv in one call; backend {t['sdpa_backend']}): not the same function, "
            "a yardstick only, the port never calls it"),
        "launches_in": (f"fp32 attention: {n_dkv} launches in phase lm-parity (a 2-layer fp32 "
                        "LM, 2 steps); the main path's LM is bf16 (flash_dkv_sm90)"),
        "lm_parity_launches": n_dkv,
        "design": ("a CTA of 8 warps a (64-key tile, b*h), heaviest first; a warp takes 16 "
                   "keys x half of each 64-query tile; K and V split to tf32 hi/lo once into "
                   "shared memory; a 2-stage cp.async Q/dO ring, each tile split once, "
                   "transposed; S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q as "
                   "mma.sync m16n8k8 tf32, each three products (3xTF32); permuted query steps "
                   "make P^T's and dS^T's C fragments the A fragments; the two query halves' "
                   "partials added through shared memory"),
        "sass": sass["flash_dkv_mma_kernel"],
    })
    src_pool = "theanompi_tpu_torch/csrc/pool.cu"
    gk = gnet_runs["pool-kernel"]
    gl = gnet_runs["library-pool"]
    for name, replaces in (("maxpool3x3_fwd", "theanompi_tpu/ops/pallas_pool.py:96"),
                           ("maxpool3x3_bwd", "theanompi_tpu/ops/pallas_pool.py:102")):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src_pool, "replaces": replaces,
            "launches": gk["launches"][name], "max_abs_err": worst_p[name],
            "ms": t["step_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "matched": True,
            "tolerance": "bit-identical to the plain version in fp32 and bf16 (a NaN matches "
                         "any NaN)",
            "tie_control_differing_share": pool_control,
            "work": (f"one training step's {len(t['per_launch_ms'])} launches over GoogLeNet's "
                     f"inception pool inputs at batch {GNET_BATCH}, bf16"),
            "ms_per_launch": t["per_launch_ms"],
            "library_note": (
                "F.max_pool2d(x, 3, 1, 1) on the channels_last view: " +
                ("its forward, the same function" if name == "maxpool3x3_fwd" else
                 "its backward alone (autograd over a kept graph), which sends each window's "
                 "gradient to its first maximum: another function on ties") +
                f"; its forward + backward {t['library_fwd_bwd_ms']:.4f} ms; the port never "
                "calls it on the kernel's route"),
            "launches_in": (f"the {GNET_STEPS}-step GoogLeNet run through the CLI with "
                            "--pool-kernel (9 inception pools; the forward also in 1 "
                            "validation batch)"),
            "main_path_step_ms": gk["summary"]["step_ms"],
            "main_path_images_per_sec": gk["summary"]["images_per_sec"],
            "without_kernel_step_ms": gl["summary"]["step_ms"],
            "without_kernel_images_per_sec": gl["summary"]["images_per_sec"],
            "resident_step_ms": gnet_runs["resident_step_ms"],
            "peak_memory_bytes": gk["peak_bytes"],
            "parity": gnet_parity,
            "design": ("a CTA a (image, 64-channel block, band of rows, <= 32 columns) stages "
                       "its halo tile (x; y and g for the backward) in shared memory by "
                       "16-byte cp.async, the frame written in place; a thread a (column, "
                       "16-byte word) walks down the band" +
                       (" keeping 3 horizontal maxima in registers" if name == "maxpool3x3_fwd"
                        else " with a 3x3 window of y and g words in registers, x straight "
                             "to registers, the nine adds in order") +
                       "; the plan from ops/pool.py:tile_plan, no 64-bit division"),
            "bound_ms_measured_rate": t["bound_ms_measured_rate"],
            "copy_rate_bytes_per_s": t["copy_rate"]["rate"],
            "ptxas": {k_: v_ for k_, v_ in ptxas_pool.items() if k_.startswith(name[-3:])},
        })
        gf = feed_runs["googlenet-imagenet_synthetic"]
        kernels[-1]["feed_main"] = {"launches": gf["launches"][name],
                                    "step_ms": gf["summary"]["step_ms"],
                                    "resident_step_ms": gf["resident_step_ms"]}
    for k in kernels:
        if k["name"] in ("fused_momentum", "quant_block", "dequant_block"):
            # phase resume's runs: each attempt's count on each rank
            k["resume_launches"] = {
                label: {run: [[c.get(k["name"], 0) for c in attempt] for attempt in attempts]
                        for run, attempts in r["launches"].items()}
                for label, r in resume_runs.items() if r["ranks"] > 1 or k["name"] ==
                "fused_momentum"}
    for k in kernels:
        if k["name"] in ("fused_momentum", "quant_block", "dequant_block"):
            # phase bsp-exchange's runs, each rank's count
            k["bsp_exchange_launches"] = {
                label: [c[k["name"]] for c in r["kernel_launches_per_rank"]]
                for label, r in exchange["runs"].items()}
    for k in kernels:
        # each model's pair of phase-graph runs: launches eager and in
        # captured groups (equal, or the phase failed)
        k["graph_launches"] = {label: {mode: graph_runs_[label][mode]["launches"][k["name"]]
                                       for mode in ("eager", "captured")}
                               for label in graph_runs()}
    print("[new-paths] " + json.dumps({
        "e2e": {k: e2e[k] for k in ("value", "step_ms", "wait_ms", "wait_frac",
                                    "host_blocked_frac", "mfu", "recovery_overhead_frac")},
        "scaling": [{k: x[k] for k in ("n_devices", "backend", "images_per_sec", "efficiency")}
                    for x in scaling["table"]],
        "lm350": {"step_ms": lm350_run["summary"]["step_ms"],
                  "tokens_per_sec": lm350_run["tokens_per_sec"],
                  "peak_bytes": lm350_run["peak_bytes"]},
        "remat_parity": {k: remat[k] for k in ("rel_change_vs_cpu", "rel_change_vs_no_remat",
                                               "bit_identical_to_no_remat")}}), flush=True)
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
