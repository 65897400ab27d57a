"""Drive the PyTorch port on one NVIDIA GPU, end to end: the Burgers serving
path, the abgrall_admm Adam phase, the L-BFGS phase of the hybrid schedule
with the generic Adam step (abgrall_admm and burgers_forward), the scale
slice (burgers_scale at 1,048,576 points in 128 microbatches, float32 and the
bf16 stream policy on kernel K6), the Euler strong-form slice (euler_admm
served and trained on the Taylor-1 kernel K7a and K5), the CLI's way from a
trained model to serving (train --resume, export --checkpoint, eval), and the
weak-form slice (twosin_weak and euler_inverse trained over the flux
quadrature kernel K7b, around K7a and K5), and the shock-path slice
(euler_weak_fast trained and served with two trainable shock paths computed
inside K7a's and K5's input passes and the strong mass residual at the cell
centres), and ensembles (train --ensemble and sweep over rho and seeds,
the Adam epochs of all members in one call of the member-batched kernel K8),
and serving them (export --calibrate / --select, predict --bands, eval
--artifact, HTTP bands over K8s: K1 with a member axis and the member
reduction), and K9: the fused step's chunks (solo K3 and K8) as captured
CUDA graphs, replayed from a device-side epoch cursor, and K10: the L-BFGS
solve of the hybrid phase on the device (K3's value-and-grad, the control
kernel and the direction kernel on a thread block cluster, replayed from a
captured graph), and slice 2b-iii's first part: the entropy penalty on the
weak form through K7b's entropy mode, and the Euler L-BFGS branch
(euler_weak_tail resumed from euler_weak_fast members through the CLI, its
solve on K10's kernels around autograd through the Euler loss), and K10's
outer epochs as chunks on the card (the flagship's L-BFGS phase: each solve
replayed to its done flag, then K3's post-update mode and the reset in place
as one more graph), and the rest of slice 2b-iii: Fourier features in K1/K2,
K7a and K5 and shock paths in K1/K2, trained and served; the weak-form ADMM;
RAD resampling and SWA averaging, solo and in an ensemble; and float64 on
the card: polish, the float64 L-BFGS polish of a checkpoint, on the float64
modes of K10 and of the narrow K1, K2 and K5; and the data generators, the
finite-volume solves of the grids on the FV time stepper K12.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:
  1 device  CUDA present, card name and power limit, TF32 off
  2 build   nvcc builds every kernel from pinns_tpu_torch/csrc, one process
            per source, all started together
  3 kernel  Taylor-2 kernel vs the plain PyTorch recurrence on the card: the
            served 8x20 model within TOL; a seeded random 8x200 net against
            the float64 recurrence (see compare_f64)
  3b ragged K1 and K6 (keep {}, keep {xx}, max) at ragged and edge shapes:
            8x200 at N 1, 31, 8,191 and 65,537, 8x50 (no whole column groups,
            4-byte weight copies) and 8x20 (the narrow design) at N 1, 31 and
            8,191; held over at least 8,191 points (phase 3's f64 oracle for
            K1, K6_PLAIN_TOL and K6_FACTOR for K6), and a call of fewer points
            equal bit for bit to the same points inside the 8,191-point call
  4 slice   committed JAX fixture -> export -> ServedModel(device="cuda")
            -> predict(25,600 points); u, f and rel-L2 against JAX's, and the
            kernel launch count of that run
  5 http    the HTTP server on an ephemeral port: /meta, JSON and npy bodies,
            a malformed body
  6 times   CUDA-event medians of kernel vs plain, host-clock medians of
            served predict
  7 step-kernel  the fused Adam-epoch kernel vs the plain step on the card:
            the narrow design at abgrall_admm's shape (8x20, N_f 1000, N_u
            100, admm rho 10): loss, terms, gradient, the Adam stage on the
            kernel's gradient, z/dual and misfit within STEP_TOL; the wide
            design at abgrall_l1's 8x200 net (l1_sq_norm) and at abgrall_admm
            with that net: gradient and loss against the float64 plain step,
            the Adam stage on the kernel's own gradient (close_adam_params),
            the drawn points equal to the plain step's, z/dual and misfit
            (admm) within STEP_TOL; the Philox points in [lb, ub) with mean
            and variance within 4 sigma; two calls equal bit for bit on every
            output; the launch count
  8 train-slice  the committed JAX fixture (abgrall_admm, seed 1234) replayed
            step by step through the kernel, each step fed JAX's points
  9 train   Trainer(abgrall_admm, device="cuda").train() for TRAIN_EPOCHS
            epochs on the kernel with its own Philox stream: loss and ADMM
            misfit fall, all finite, u rel-L2 inside the band the fixture
            records from three JAX seeds; every epoch inside a replay of K9's
            graphs (GRAPH_EPOCHS), no host call of K3 (LAUNCHES); the launch
            counts of that run
  9b train-wide  Trainer(abgrall_l1) on the TwoSin grid through the wide K3
            for WIDE_EPOCHS epochs: finite losses that fall, every epoch in a
            K9 replay, no call of a plain version; then ABGRALL_EPOCHS epochs
            on its own committed grid (abgrall_burgers_shock), again through K3
  times     ms per epoch of the kernel step and the plain step (CUDA events,
            medians) at 8x20 and 8x200 beside step_bound, and wall time per
            1,000-epoch chunk at each
  10 k5     the fused MLP forward (K5) and its backward against the plain
            versions: the narrow design at 8x20 (N 100, 25,600); the wide
            design, against float64, at 8x200 (N 100, 2,000, 8,192, 65,536)
            and on the Euler trunk 2x200x5x3 (out_dim 3, N 200); two backward
            calls agree bit for bit
  11 k2     the Taylor-2 backward (K2) against autograd through the plain
            recurrence at 8x20 (N 1,000 and 10,456) and 8x200 (N 1,000,
            8,192 and 65,536); its plan (padding, dW's split, scratch)
  12 cross-check  the generic loss's gradient (K5 + K1/K2 under autograd)
            against K3's grad kernel at the JAX fixture's state
  13 lbfgs-replay  the host loop (opt/lbfgs.py::lbfgs_minimize, K10's plain
            version) on the card from that state for 1, 2, 5 iterations
            against JAX's float32 iterates (equal n_iters), a 200-iteration
            solve's final loss within 1% of JAX's; the ms per iteration and
            per value-and-grad, and host syncs per iteration
  14 hybrid phase 9's state continued through Trainer.train over the switch:
            10 L-BFGS outer epochs (of at most 300 iterations, the fixture's
            schedule) as chunks of K10's runner (LBFGSChunk): each solve on
            K10 (K3's value-and-grad, the control and direction kernels; one
            launch of its WHILE-node graph), then K3's post-update mode (the
            batch, z, dual, the data-term metric and the metrics row) and the
            reset in place, replayed as one graph: no launch of K1, K5 or K2
            and no torch Philox draw in the L-BFGS phase, no plain call, no
            host loop, K3's epoch never launched again, one host sync a
            chunk, under k steps after each solve's end; loss does not rise;
            u rel-L2 in the band of
            three JAX seeds at the same schedule
  15 burgers_forward  a reduced schedule (the fixture's: 3,000 cosine Adam
            epochs on the generic step, one L-BFGS outer epoch of at most
            1,000 iterations) for JAX's three band seeds: no plain call, the
            median u rel-L2 in the band of JAX's three
  times     K5 and K2 against plain (CUDA events) and the generic step
            against the plain step for burgers_forward
  16 k6     the mixed Taylor-2 kernel (K6) and its backward against the plain
            mixed version at 8x200, N 8,192 and 65,536, for keep {}, keep {xx}
            and max: per stream (per gradient leaf) within K6_FACTOR x the
            plain version's error against float64; the backward also within
            max-relative 0.2 of autograd through the plain version; two
            backward calls agree bit for bit; the backward's plan
  17 scale-replay  the committed JAX fixture (burgers_scale_steps.npz: 8x200,
            16,384 points in 2 microbatches, 3 Adam steps on fed points) through
            the generic step: float32 losses within rtol 1e-4 and the step-0
            gradient by close_grad; keep {xx} and max losses within the f32
            envelope, per-leaf gradient norms within 5% of JAX's
  18 burgers_scale  Trainer.train on the preset at full size (8x200,
            1,048,576 points, 128 microbatches), SCALE_EPOCHS epochs each of
            f32, keep {xx} and max: finite loss that falls, 128 forward and
            128 backward launches of K1/K2 (f32) or K6 (mixed) per epoch, no
            K3 and no plain call; ms per epoch and peak device memory
  times     K6 forward and backward against plain (CUDA events)
  19 euler-serve  the native abgrall_eulers grid (300 x 157) against the
            committed JAX fixture (euler_admm.npz) within 1e-12; the
            fixture's trunk (2x200x5x3) -> export -> ServedModel: rho, u, E
            and f1, f2, f3 at the 47,100 grid points and at ragged N against
            JAX's (TOL) and against the plain version on the card; K7a's
            launches in that predict; one HTTP round trip; the served
            predict's time at 47,100 points
  20 k7a    the Taylor-1 kernel (K7a) and its backward against the plain
            versions at the Euler trunk (the wide design, against float64,
            compare_f64) and at 2x20x3x3 (both designs, TOL of plain
            float32; a gradient leaf whose sum cancels against float64), N
            1,000, 8,192, 65,536, and at 8x20 x 16,000 and 25,600 (both
            designs); the narrow design's forward equal to the wide one's
            bit for bit; two backward calls agree bit for bit; the launches
            a call of each design
  21 euler-step  one euler_admm Adam step on the card (K5 + K7a under
            autograd) from the fixture's JAX state at its points: loss and
            every gradient leaf (close_grad), z and dual of each component,
            the new params; then the fixture's short replay
  22 euler-train  euler_admm through Trainer.train at the fixture's reduced
            schedule for JAX's three band seeds: no plain call, every epoch
            on K7a and K5, the median rel-L2 of each field in the band of
            JAX's three seeds; euler_admm_tuned once for UNHELD_EPOCHS
            (curriculum, field weights; its rel-L2 printed, not held)
  times     the Euler epoch (CUDA events) and a 1,000-epoch chunk; K7a and
            its backward against autograd through plain at N 1,000 and 65,536
            on the trunk, at 8x20 x 16,000 and 25,600 (the narrow design,
            beside the wide one), with the launches a call
  23 p2     the CLI in this process: train abgrall_admm for P2_EPOCHS epochs
            (K3), export --checkpoint, predict over the grid, eval
            --checkpoint and eval --artifact, all at the train summary's u
            rel-L2 (1e-7); train half the epochs and --resume to the end: the
            final checkpoint equal to the uninterrupted run's bit for bit
  24 k7b    K7b against its plain version: the edge points bit for bit; r and
            the backward (g_y, g_yx, the coefficients' gradient) within rtol
            1e-4 / atol 1e-5 max|plain| or the float64 criterion (compare_f64;
            the backward against autograd through the plain forward), Burgers
            and Euler, viscous and inviscid, N 1,000 and 65,536, centers on the
            bounds; two backward calls bit for bit; K7a at twosin_weak's shape
            (8x20, out 1, 16,000 points) against float64
  25 weak-step  one step of twosin_weak and euler_inverse on the card from the
            JAX fixture's state (weak_flux.npz): loss, every gradient leaf and
            the coefficients' gradient (the viscosity's for euler_inverse) by
            close_grad; then the fixture's 3-step replay (metrics, the
            coefficients, each leaf's sums, the params after the first step)
  26 weak-train  twosin_weak through Trainer.train at the fixture's reduced
            schedule (3,000 epochs of the cosine schedule, uncut) for JAX's
            three band seeds: every epoch on K7b, K7a and K5, no plain call,
            the median u rel-L2 in the band of JAX's three seeds;
            euler_inverse once for UNHELD_EPOCHS (rel-L2 and the identified
            viscosity printed, not held)
  times     K7b's edge points, quadrature and backward against the plain
            versions (CUDA events) at N 1,000 and 65,536 beside their bounds;
            each weak preset's epoch (events) and a 1,000-epoch chunk
  27 k7a/k5-paths  K7a and K5 (wide) with two shock paths on the Euler trunk
            at N 200, 1,000, 16,000 and 65,536 against float64: each stream
            and each gradient leaf, path_c and path_a included, within 4x the
            plain float32 version's error plus 1e-6 max|exact| (compare_f64);
            two backward calls bit for bit
  28 weak-paths-step  one euler_weak_fast step on the card from the JAX
            fixture's state (euler_weak.npz): loss and every gradient leaf
            (close_grad, the path leaves included), the launches of one loss;
            then the fixture's 3-step replay
  29 euler_weak_fast  the preset through Trainer.train at the fixture's
            reduced schedule (2,000 epochs, uncut cosine) for JAX's three band
            seeds: every epoch on K7b, K7a (edge points and centres) and K5,
            no plain call, the median rel-L2 of each field within JAX's three
            seeds +- PATH_MARGIN; the first seed's checkpoint through the CLI
            (export --checkpoint, eval --artifact at the train rel-L2); the
            fixture's JAX-trained path net served (K7a) at its grid points
            within rtol 1e-5 / atol 1e-5 max|JAX|, and over HTTP
  times     K7a and K5 with and without paths (events) beside their bounds,
            the plain versions; the euler_weak_fast epoch (events) against the
            plain step, and a 1,000-epoch chunk
  30 k8     K8, the member-batched narrow K3, at abgrall_admm's 8x20 for E =
            1, 3, 8 and 32 with rhos 10, 20, 30, ... and seeds 1234 + i: every
            output of every member equal to a solo K3 call (torch.equal) over
            5 chained epochs, and the first epoch of each member within
            STEP_TOL of the plain step at its rho; one host call an epoch;
            the same epochs as one graphed K8 chunk (K9) equal to the
            chained calls bit for bit
  31 ensemble-cli  this slice's main path, the CLI in this process: train
            abgrall_admm --ensemble 4 for 510 epochs (500 Adam epochs on K8,
            then 10 L-BFGS outer epochs of at most 20 iterations per member)
            with --select: no plain call, every Adam epoch a replayed K8
            epoch (K9); each member's
            final checkpoint equal to its solo run's (train --seed 1234+i) bit
            for bit, and --resume from the epoch-500 set ending at the same
            states; sweep --grid loss.rho=10,40 --grid train.seed=1234,7 for
            300 epochs as one 4-member unit, every row ok
  times     a K8 epoch (events) and a 1,000-epoch chunk's member-epochs a
            second at E = 1, 8 and 32 (the chunk replayed from K9's graphs)
            beside the solo K3 step; the plain per-member loop at E = 8
  33 k8s    K8s (a), K1 with the member as blockIdx.y, at 8x20 (narrow) and
            8x200 (tiled), E = 1, 3, 8, N = 1, 31, 25,600: every member's
            four streams equal a solo K1 call (torch.equal); K8s (c), the
            member reduction, against float64 by compare_f64 and equal to
            its arithmetic spelled in member order (torch.equal) at E = 1,
            3, 8, 16, 32, 33 on the Euler ensemble's shape (47,100 points, 6
            fields, 3 dx), and at E 8 on 47,101 points (scalar loads) and 7
  34 ens-fixture  the committed JAX ensembles (ensemble_serve.npz: Burgers
            8x20 E 4, the full-width euler_weak_fast trunk with two shock
            paths E 3) through uq_calibration on the card against JAX's rows
            (hold_rows), exported and served on the card: mean and dx rtol
            1e-5 / atol 1e-5 max (1e-4 for f, f1..f3), std atol 1e-5 of
            max|mean|; the served points' Mondrian bins against JAX's
  35 ensemble-serve  this slice's main path, the CLI and HTTP in this
            process, no plain call: phase 31's four abgrall_admm members ->
            export --calibrate (--mond-feature std and dx) -> predict --bands
            -> eval --artifact -> HTTP (/meta, bands by JSON and npy, a 400
            for bands on a point artifact); train euler_weak_fast --ensemble
            8 for ENS_EULER epochs -> export --calibrate (dx) at the 47,100
            grid points -> the same -> export --select rank --anchor, with
            meta['selection']
  times     served ensemble predict (host clock) at 25,600 (Burgers, E 8)
            and 47,100 points (Euler, E 8) with and without bands; K8s (a)
            against 8 solo K1 calls and the plain version, (c) beside its
            bound, its plain version and torch.std_mean (CUDA events, the
            three in turns over 200 rounds)
  36 k9     K9: chunks replayed from captured CUDA graphs against the
            per-epoch loop (the plain version), torch.equal on params, mu,
            nu, colloc, z, dual and every metrics row: the narrow K3 at
            abgrall_admm's 8x20 for L = 1, 2, 7, 1,000 and 2 x 500 against
            1 x 1,000; the wide K3 at 8x200 (abgrall_l1's l1_sq_norm, and
            admm) for L = 1, 3, 50; K8 at E = 1, 3, 8, 32 with distinct rhos
            and seeds, drawn and fed given points
  times     1,000-epoch chunks graphed against the per-epoch loop, 10
            alternating turns a side (host clock): epochs a second at 8x20
            and 8x200, member-epochs a second for K8 at E 8 and 32; the
            one-off capture time, the replays and replayed epochs; at 8x20
            and for K8 each narrow K3 kernel's device time an epoch
            (torch.profiler) beside its bound and the 64-point design's
  37 k10    K10 from phase 13's state: K3's value-and-grad mode against the
            autograd gradient and its plain version (phase 12's criterion,
            close_grad); the reset, control and direction kernels against
            their plain versions bit for bit after every launch of a solve
            stepped one evaluation at a time (the history filled and its head
            wrapped); the solve as one launch of its WHILE-node graph
            (SolveLoop) against JAX's iterates at 1, 2, 5 iterations (equal
            n_iters, x within ITERATE_STEP_TOL / ITERATE_ULP_TOL), the long
            solve's f inside LONG_SOLVE_BAND and at or below the 5-iteration
            f, equal to the stepwise solve (x, f, g, n_iters, n_evals, the
            branches) and to a second solve bit for bit, one host sync and
            under k steps after the end a solve; times: the long solve on
            K10 and on the host loop in K10_TURNS alternating turns (ms,
            device time by the profiler and, for K10, by CUDA events around
            the loop's launch, launches and host syncs per iteration), each
            kernel's device time
            on the heaviest input the solve met beside its plain version and
            its bound; the layouts (csrc/lbfgs.cu): the direction kernel
            (a cluster: the pairs resident at the fixture's 3,023 params)
            taking the descent guard (a seeded history, an uphill gamma) and
            the streamed design at the scope's largest net (K10_WIDE params,
            a quartic valley stepped in lockstep) bit for bit against their
            plain versions; the direction kernel's streamed design timed
            on the same heaviest input as the plan's resident one
  38 k7b-entropy  K7b's entropy mode (the weak entropy violation relu(e)^2
            from the same quadrature, its adjoint in the backward) against
            the plain quadrature with want_entropy: Burgers and Euler,
            viscous and inviscid, N 1,000 and 65,536, r, relu(e)^2 and the
            backward by the float64 criterion, r bit-equal to the mode
            without the entropy, two calls bit-equal, times beside
            k7b_entropy_bytes; an entropy-weighted (ENTROPY_WEIGHT) step of
            twosin_weak and of euler_weak_fast at full width from their
            fixtures: loss and gradient against the plain path and float64,
            the entropy mode's one forward and one backward launch, no plain
            call
  39 euler-tail  the Euler L-BFGS branch: K10's direction and control
            kernels bit-equal to their plain versions at the Euler trunk's
            162,413 params and a full history of 50 pairs (a seeded
            history, a quartic valley), each timed beside its bound;
            euler_weak_tail's solve from the JAX fixture
            (euler_weak_tail.npz) at max_iters 1, 2, 5 on K10
            (AutogradLBFGS, its evaluation captured into the solve's WHILE
            node, one launch and one read a solve; bit-equal to the same
            solver host-stepped) and on the host loop: n_iters and n_evals
            equal to JAX's, f within STEP_TOL; a TAIL_TIMED_ITERS-iteration
            outer epoch on K10 (captured, and host-stepped) and on the host
            loop in turns (ms, device time, launches, host syncs per
            iteration); this slice's main path: train --preset
            euler_weak_tail --resume from two of phase 35's members for two
            outer epochs, then export --select rank of the tails against
            them: every solve on K10, no plain call
  40 lbfgs-chunk  K10's outer epochs as chunks: K3's post-update mode
            against its plain version on the card at the fixture's state
            (abgrall_admm at 8x20, N_f 1,000, N_U 100): the batch equal to
            philox_uniform, z, dual, the misfit and the data term within
            POST_TOL or the float64 criterion; chunks of L = 1, 3 and 10
            outer epochs, drawn and fed, bit-equal (x, batch, z, dual, every
            metrics row) to the same kernels driven one outer epoch a host
            call, one loop launch an outer epoch and one host sync a chunk
            (after it); one outer epoch from the fixture's state at 5 iterations
            against JAX's (phase 37's criteria); times from phase 9's state
            at phase 14's schedule in turns: ms an outer epoch on the runner
            and on the per-outer-epoch step, and each one's wall time outside
            the solve (the solves bracketed by synchronizes); the post-update
            mode's device time beside its plain version and its bound
  41 generic-chunk  K11, the generic step's Philox draw, bit-equal to
            philox_uniform at n_f 1,000 and 1,048,576, epochs 0, 1 and
            2^32 + 5, from the schedule row at a device cursor, timed beside
            it; K9 for the generic step (ops/kernels/generic_chunk.py: one
            captured epoch replayed L times) against the per-epoch loop by
            torch.equal on params, mu, nu, colloc, z, dual and every metrics
            row for every generic family in scope (euler_admm,
            euler_admm_tuned, twosin_weak, euler_weak_fast, euler_inverse,
            burgers_forward, hwan_admm, burgers_inverse) at L = 1, 2, 7 and
            2 x 50 = 1 x 100, drawn and fed; then 1,000-epoch graphed chunks
            against the per-epoch loop in alternating turns for euler_admm,
            twosin_weak, euler_weak_fast, euler_inverse and burgers_forward:
            ms an epoch, device time, idle share, launches, step calls and
            graph replays an epoch. Phases 15, 22, 26 and 29 train every
            Adam epoch inside its replays (GRAPH_EPOCHS) and draw with K11
  42 fourier-kernels  K1 (tiled) and K2, K7a (wide) and K5 (wide) with
            Fourier features (F 16, sigma 3: input width 34) and K1/K2 with
            two shock paths, against the plain version and float64 on every
            stream and gradient leaf (4x the plain float32 error), two
            backward calls bit for bit; event times beside the plain version
            and beside the same kernel without the features
  43 fourier-train  burgers_forward --set model.n_fourier=16 from the
            fixture's JAX state (tests/fixtures/torch_port/slice2b_rest.npz):
            one step and a 3-step replay against JAX, the graphed chunk
            bit-equal to the per-epoch loop, a 2,000-epoch run; euler_admm
            with Fourier features: one step against JAX; a JAX-trained
            Fourier net served (predict and HTTP) against JAX's outputs;
            300-epoch runs of euler_admm and euler_weak_fast (with paths)
            with Fourier features and of burgers_forward with paths, their
            launches the kernels line's
  44 flux-admm  euler_admm --set loss.admm_form=flux at the trunk: one step
            and a 3-step replay against JAX with z and the dual on the
            weak-form cells, the graphed chunk bit-equal to the loop, its
            L-BFGS outer epoch on AutogradLBFGS
  45 rad-swa  RAD on abgrall_l2 (8x200) and hwan_admm (ADMM re-initialised):
            p through the kernels against the plain p and JAX's on one pool,
            three chunk boundaries with their redraws; SWA on twosin_weak
            against a plain running mean of its snapshots; train --ensemble
            3 with SWA, each member's SWA and final states equal to its solo
            run's
  46 polish  the float64 modes: K1 and K2 at 8x20 on burgers_forward's
            10,456-point batch and K5 forward and backward at its 100 data
            points against their float64 plain versions within 1e-12
            max|plain| per stream and leaf (a cancelling leaf: of its sum
            of absolute terms), two calls bit-equal; K10's reset, control
            and direction at n 3,023 and a history of 50 (the streamed
            layout) bit for bit against their float64 plain versions, on a
            seeded history and after every launch of a polish's first 20
            iterations; then polish (train.polish, 200 iterations) from the
            committed JAX state (FIXTURE) at the fixed anchored batch: the
            float64 modes launched, no float32 kernel, no plain version, no
            host loop (one launch of the solve's WHILE node, one host sync),
            two runs bit-equal, bit-equal to the host-stepped AutogradLBFGS
            over the same kernels, the loss no higher, the first 20
            iterations against the host loop
            over the plain loss (equal n_iters, x within 1e-8 max|x|); ms,
            device time, launches and syncs an iteration, the idle share;
            each float64 mode by CUDA events beside its plain version and
            its bound at 34 TFLOP/s float64 or 3.35 TB/s
  47 dp     slice 6: ``python -m torch.distributed.run --nproc-per-node
            <torch.cuda.device_count()> scripts/dp_smoke.py`` (NCCL, one
            process a card): K3's data-parallel reduce and apply modes
            against their plain versions (8x20 'admm', 8x200 'l1_sq_norm';
            the apply mode bit for bit), the ranks' K11 draws at their row
            offsets bit-equal to one launch of the whole batch, abgrall_admm
            through Trainer.train under the data-parallel path (2,000 Adam
            epochs replayed from K9's graphs with the NCCL all-reduces
            captured, every reduce and apply launch and all-reduce counted,
            the ranks' losses equal; at one rank bit-equal to the one-card
            run, at more its gathered batch; then L-BFGS outer epochs on
            DeviceLBFGS, K3's value-and-grad split around its all-reduce, its
            16-step graph replayed by configuration), burgers_inverse's
            L-BFGS outer epochs on the host-stepped AutogradLBFGS over the
            all-reduced objective, burgers_forward's generic step data-parallel on
            K9's generic graph (the all-reduce captured), a burgers_scale
            epoch at 1,048,576 points and
            euler_weak_fast --ensemble 8 with its members over the ranks,
            timed; a failed rank fails the phase
  48 generators  slice 7, the data generators on K12 (the FV time stepper,
            one launch a solve): make_twosin_grid() (2,048 cells, 1,620
            snapshots), make_abgrall_burgers_grid() (1,024 cells, 257) and
            the euler kind (euler_solve at 1,500 cells, 157 snapshots,
            t_final 1.0) through the public functions, and the loader's
            native fallback for each of the four dataset keys (an empty
            grid directory, no reference tree): K12 launched once a Burgers
            and Euler solve, no plain call; the Burgers grids within
            FV_JAX_TOL of the committed JAX grids, the loader's equal to the
            public functions', the Euler solve's early snapshots within
            FV_EULER_BAND of the exact Riemann solution; ``python -m
            pinns_tpu_torch generate-data`` for each kind into a temp
            directory, the six processes started together (keys and shapes;
            the FV kinds equal to the in-process grids); then K12 against its plain version on the card for the
            three solves by torch.equal, two K12 calls bit-equal, both timed
            by CUDA events beside fv_bound
  49 inverse-lbfgs  burgers_inverse's L-BFGS outer epoch from INVERSE_ADAM
            Adam epochs (AutogradLBFGS around K1, K2 and K5 with the exp
            coefficient's gradient): captured into the solve's WHILE node
            (one launch, one read) against the same solver host-stepped, bit
            for bit (params, loss, iterations, evaluations, the branches); no
            plain call; both timed in turns (ms, device time, launches, host
            syncs an iteration, the idle share)
Each phase's wall time is printed. Then a {"kernels": [...]} summary line
and, last, the result line.
The script imports neither jax nor pinns_tpu (the JAX package).
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "burgers_forward_8x20.npz")
NARROW = (2,) + (20,) * 8 + (1,)  # burgers_forward / abgrall_admm
WIDE = (2,) + (200,) * 8 + (1,)  # abgrall_visc, burgers_scale
EULER = (2,) + (200,) * 5 + (3,)  # the Euler slices' trunk (presets.py: euler_*)
EULER_NARROW = (2,) + (20,) * 3 + (3,)
LB, UB = (-1.0, 0.0), (1.0, 0.99)
# (layers, N): the served shapes of the main path (25,600 grid points, padded
# to the 32,768 bucket), a small request, a 1M-point batch, and the wide net
# at one burgers_scale microbatch and at 65,536
KERNEL_SHAPES = [(NARROW, 64), (NARROW, 25_600), (NARROW, 32_768),
                 (NARROW, 1_048_576), (WIDE, 8_192), (WIDE, 65_536)]
MAIN_SHAPE = (NARROW, 32_768)
STREAMS = ("u", "u_x", "u_t", "u_xx")
# rtol and atol (as a multiple of max|reference|) per stream: u_xx sums eight
# layers of products in another order, so it gets ten times the absolute room
TOL = {"u": (1e-5, 1e-5), "u_x": (1e-5, 1e-5), "u_t": (1e-5, 1e-5),
       "u_xx": (1e-5, 1e-4), "f": (1e-5, 1e-4),
       # the Euler fields; f1, f2, f3 sum products of three fields, which
       # cancel: their absolute room scales with max|f|
       "rho": (1e-5, 1e-5), "E": (1e-5, 1e-5), "f1": (1e-5, 1e-4), "f2": (1e-5, 1e-4),
       "f3": (1e-5, 1e-4),
       # K7a's streams against the plain float32 version at a narrow net
       "y": (1e-5, 1e-5), "y_x": (1e-5, 1e-5), "y_t": (1e-5, 1e-5)}
F64_FACTOR = 4.0
REPS = 20
KERNELS = ("taylor2", "fused_step", "mlp_forward", "taylor2_backward", "taylor1", "weakform",
           "ensemble", "lbfgs", "sampling", "fv_solve")
STEPS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "abgrall_admm_steps.npz")
# the step kernel against the plain step: (rtol, atol as a multiple of
# max|reference|, or of the scale of the terms a difference cancels; see close). Loss, terms and gradient sum in another order (the JAX
# fixture's tolerance on CPU); the Adam stage and the Philox points round
# like the plain step, so they get float32 rounding room only; z/dual come
# from a residual evaluated in another order.
STEP_TOL = {"loss": (1e-4, 1e-6), "grad": (1e-4, 1e-5), "adam": (1e-6, 1e-7),
            "colloc": (0.0, 0.0), "z": (1e-4, 1e-5), "dual": (1e-4, 1e-5),
            "admm_misfit": (1e-4, 1e-6), "k7a_grad": (1e-5, 1e-5),
            # each leaf's sum and sum of squares after an Euler step: Adam may
            # flip an entry whose gradient is within rounding of zero (2 lr)
            "leaf_sums": (1e-4, 1e-4)}
TRAIN_EPOCHS = 10_000  # the fixture's band_epochs
WIDE_EPOCHS = 300  # phase 9b: abgrall_l1's 8x200 net through the wide K3
ABGRALL_EPOCHS = 100  # phase 9b: abgrall_l1 on its own grid
BAND_MARGIN = 0.05  # three JAX seeds do not sample the tails of the seed spread
LBFGS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "lbfgs_hybrid.npz")
# K5 at the data term's 100 points and the served grid's 25,600 (8x20); the
# wide design at burgers_scale's data term (100 points), 2,000, 8,192 and
# 65,536 points and on the Euler trunk (out_dim 3) at 200; K2 at
# abgrall_admm's N_f, burgers_forward's anchored batch (10,000 LHS + 456
# IC/BC points), the wide net, one burgers_scale microbatch, and a larger call
K5_SHAPES = [(NARROW, 100), (NARROW, 25_600), (WIDE, 100), (WIDE, 2_000), (WIDE, 8_192),
             (WIDE, 65_536), (EULER, 200)]
K2_SHAPES = [(NARROW, 1_000), (NARROW, 10_456), (WIDE, 1_000), (WIDE, 8_192), (WIDE, 65_536)]
REPLAY_STEP = 5  # the fixture state the L-BFGS replay starts from
LONG_SOLVE = 200
# L-BFGS iterates against JAX's: the gradients agree to ~1e-6 relative (1e-4
# on a leaf whose sum cancels), so the step each solver takes agrees to well
# within 1% of its size; both round x + a d in float32 (a few ulps of max|x|)
ITERATE_STEP_TOL, ITERATE_ULP_TOL = 1e-2, 1e-6
# after some dozens of float32 iterations the two trajectories part (sums in
# other orders) and each stops where its line search runs out: the final f of
# the long solve is held to 1% of JAX's
LONG_SOLVE_BAND = 0.01
HYBRID_OUTER = 10
BF_MARGIN = 0.05  # as BAND_MARGIN: three JAX seeds at the reduced schedule
SCALE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "burgers_scale_steps.npz")
# the bf16 stream policies of burgers_scale (experiments.presets.STREAM_POLICIES):
# the JAX package's recommended keep {xx}, the TPU kernel's own keep {}, and
# bench.py's mixed run (max)
K6_POLICIES = ("keep_none", "keep_xx", "max")
# phase 3b: (layers, N) of K1 and K6 off the main path's shapes
RAGGED_SHAPES = [(WIDE, 1), (WIDE, 31), (WIDE, 8_191), (WIDE, 65_537),
                 ((2,) + (50,) * 8 + (1,), 1), ((2,) + (50,) * 8 + (1,), 31),
                 ((2,) + (50,) * 8 + (1,), 8_191), (NARROW, 1), (NARROW, 31), (NARROW, 8_191)]
K6_SHAPES = [(WIDE, 8_192), (WIDE, 65_536)]  # one burgers_scale microbatch, and a larger call
K6_MAIN = ("keep_xx", WIDE, 8_192)
# the TPU test's envelope (89afc4b^:tests/test_pallas.py:87-109): K6 against
# float64 at most twice the plain mixed version's error
K6_FACTOR = 2.0
# K6 and its backward against the plain mixed version on the same inputs:
# max|K6 - plain| <= K6_PLAIN_TOL max|plain| per stream and per gradient leaf.
# Sums of bf16 x bf16 products are mostly exact in float32, so the two differ
# by the order of their float32 sums: at most 4.3e-6 of max|plain| on the
# streams and 3.8e-6 on the leaves (H100). A K6 that skipped or misplaced a
# rounding would be off by the quantization error: 2.7e-2 to 6.5e-1 of
# max|plain| on the streams, 2e-3 to 1e-2 on every leaf but the head's bias,
# which no rounding reaches
K6_PLAIN_TOL = 3e-5
SCALE_EPOCHS = 5
SCALE_POLICIES = ("f32", "keep_xx", "max")
EULER_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "euler_admm.npz")
EULER_FIELDS = ("rho", "u", "E")
EULER_OUT = EULER_FIELDS + ("f1", "f2", "f3")
EULER_RAGGED = (1, 37, 8_191)
# K7a at the Euler batch's 1,000 points, 8,192 and 65,536, on the trunk and
# on a narrow net, and at 8x20 x 25,600 (a served Burgers ensemble's d/dx);
# each net of widths <= 32 through both designs; timed at 1,000 and 65,536
# (the trunk) and at 16,000 (twosin_weak's edge points, the narrow design's
# main shape) and 25,600 (8x20)
K7A_SHAPES = [(EULER, 1_000), (EULER, 8_192), (EULER, 65_536),
              (EULER_NARROW, 1_000), (EULER_NARROW, 8_192), (EULER_NARROW, 65_536),
              (NARROW, 25_600)]
K7A_MAIN = (EULER, 1_000)
K7A_NARROW_MAIN = (NARROW, 16_000)
K7A_TIMES = [(EULER, 1_000), (EULER, 65_536), K7A_NARROW_MAIN, (NARROW, 25_600)]
EULER_MARGIN = 0.05  # as BAND_MARGIN: three JAX seeds at the reduced schedule
# the epochs of the runs printed and held to no band (euler_admm_tuned in
# phase 22, euler_inverse in phase 26): two logs of the loss (log_every
# 1,000), so that its fall is checked, and well inside the time limit
UNHELD_EPOCHS = 2_000
# published peaks of one H100 SXM (dense), for the bounds in the kernels line
PEAK_FP32, PEAK_BF16, HBM_BYTES_PER_S = 67e12, 989e12, 3.35e12


def timed(card: str, name: str, fn, *args):
    """fn(*args), then a line with its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit(card, phase="wall", of=name, seconds=time.perf_counter() - t0)
    return out


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(card: str, **fields) -> None:
    print(json.dumps({**fields, "card": card}), flush=True)


def compare(name: str, got: np.ndarray, want: np.ndarray) -> dict:
    """Max abs error of ``got`` against ``want`` beside TOL[name]; raises if over."""
    rtol, atol_rel = TOL[name]
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}")
    check(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    atol = atol_rel * float(np.abs(want).max())
    err = np.abs(got - want)
    ok = bool((err <= atol + rtol * np.abs(want)).all())
    row = {"max_abs_err": float(err.max()), "atol": atol, "rtol": rtol, "ok": ok}
    check(ok, f"{name}: {row}")
    return row


def compare_f64(name: str, got, plain, exact, factor: float = F64_FACTOR) -> dict:
    """The kernel against the float64 recurrence, beside the plain float32
    recurrence's own error: the kernel passes when its error is at most
    ``factor`` times the plain version's plus 1e-6 max|exact|. (For a deep
    random net the outputs come out of sums of much larger terms, and float32
    itself misses 1e-5 max|.|, whatever order it sums in.)"""
    got, plain, exact = (np.asarray(a, np.float64) for a in (got, plain, exact))
    check(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    err = float(np.abs(got - exact).max())
    plain_err = float(np.abs(plain - exact).max())
    bound = factor * plain_err + 1e-6 * float(np.abs(exact).max())
    row = {"max_abs_err_vs_plain": float(np.abs(got - plain).max()),
           "max_abs_err_vs_f64": err, "plain_err_vs_f64": plain_err,
           "bound": bound, "ok": err <= bound}
    check(row["ok"], f"{name}: {row}")
    return row


def points(n: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.uniform(LB, UB, size=(n, 2)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def event_ms(fn) -> float:
    """Median milliseconds of ``fn`` over REPS runs, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def event_ms_turns(fns, reps: int) -> list:
    """Median milliseconds of each of ``fns`` by CUDA events, after warm-up,
    timed in turns (one call of each, ``reps`` rounds), so that two launch-
    and host-bound calls meet the host's drift alike."""
    for fn in fns:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [statistics.median(ts) for ts in times]


def host_ms(fn) -> float:
    """Median wall milliseconds of ``fn`` (which ends in a device->host copy)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def http(url: str, body: bytes = None, ctype: str = "application/json"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def measure(name: str, got, want, scale=None) -> dict:
    """Max abs error of ``got`` against ``want`` beside STEP_TOL[name]. The
    atol is relative to ``scale`` (default max|want|): the dual update
    dual + rho (f - z) cancels terms of size max|dual| + rho max|z|, and the
    misfit mean|f - z| terms of size max|z|, so their rounding scales with
    those; a loss term is held at the loss's absolute accuracy."""
    rtol, atol_rel = STEP_TOL[name]
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    check(got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}")
    check(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    atol = atol_rel * float(np.abs(want).max() if scale is None else scale)
    err = np.abs(got - want)
    ok = bool((err <= atol + rtol * np.abs(want)).all())
    return {"max_abs_err": float(err.max()), "atol": atol, "rtol": rtol, "ok": ok}


def close(name: str, got, want, scale=None) -> dict:
    """:func:`measure`, raising if over."""
    row = measure(name, got, want, scale)
    check(row["ok"], f"{name}: {row}")
    return row


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def split_leaves(flat: np.ndarray, layers) -> list:
    """A flat W_0, b_0, W_1, ... vector cut into its leaves."""
    out, off = [], 0
    for din, dout in zip(layers[:-1], layers[1:]):
        for n in (din * dout, dout):
            out.append(flat[off:off + n])
            off += n
    return out


def close_grad(got: np.ndarray, want: np.ndarray, layers, exact: np.ndarray,
               sizes=None) -> dict:
    """The gradient leaf by leaf, each within STEP_TOL['grad'] of its own max.
    A leaf that misses it must pass the float64 criterion instead (compare_f64
    against ``exact``, the float64 plain gradient, beside ``want``'s own
    error): once a sum over the points cancels, float32 itself misses a
    max-relative atol, whatever order it sums in. ``sizes`` (the leaves'
    sizes) cuts a flat vector that is not W_0, b_0, ... of ``layers`` alone
    (a shock-path net's)."""
    rows = []
    cut = ((lambda a: np.split(a, np.cumsum(sizes)[:-1])) if sizes is not None
           else (lambda a: split_leaves(a, layers)))
    for g, w, e in zip(*(cut(a) for a in (got, want, exact))):
        row = measure("grad", g, w)
        if not row["ok"]:
            row = dict(compare_f64("grad", g, w, e), max_abs_err=float(np.abs(g - w).max()))
        rows.append(row)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), "leaves": len(rows),
            "leaves_by_f64_oracle": sum("bound" in r for r in rows)}


def plain_gradient(problem, params, colloc, admm, dtype=None, rho=None):
    """(flat gradient of the net, aux) of the plain loss by torch.autograd,
    computed in ``dtype`` when given (``problem`` must then be built in it),
    at ``rho`` when given (else loss.rho)."""
    from pinns_tpu_torch.train import trainer as tr

    cast = (lambda t: t.to(dtype)) if dtype is not None else (lambda t: t)  # noqa: E731
    params = tr.tree_map(lambda t: cast(t).detach().clone().requires_grad_(True), params)
    if admm is not None:
        admm = type(admm)(z=tr.tree_map(cast, admm.z), dual=tr.tree_map(cast, admm.dual))
    loss, aux = tr.make_loss_fn(problem, plain=True)(params, cast(colloc), admm, rho)
    g = torch.autograd.grad(loss, tr.tree_leaves(params["net"]))
    return torch.cat([t.reshape(-1) for t in g]), {k: float(v.detach()) for k, v in aux.items()}


def close_adam_params(got: np.ndarray, want: np.ndarray, lr: float) -> dict:
    """Params after a step from two implementations: Adam moves an entry by at
    most about lr, and an entry whose gradient is within rounding of zero may
    move the other way, so the bound is 2 lr; all but 1% of the entries must
    agree within 1e-6."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    row = {"max_abs_err": float(diff.max()), "bound": 2 * lr * (1 + 1e-3),
           "share_above_1e-6": float(np.mean(diff > 1e-6))}
    check(bool(np.isfinite(got).all()), "params: non-finite values")
    check(row["max_abs_err"] <= row["bound"] and row["share_above_1e-6"] <= 0.01,
          f"params after the step: {row}")
    return row


def hold_narrow_step(problem, lr: float, state, r: dict) -> dict:
    """One narrow K3 (or K8 member) epoch's outputs ``r`` from ``state``
    against the plain step at the state's rho: the loss and its terms, the
    gradient (close_grad, float64 for a cancelling leaf), the Adam stage on
    the kernel's gradient, the drawn points, z, dual and the misfit, each
    within STEP_TOL. Returns the rows."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params
    from pinns_tpu_torch.opt.adam import AdamState, adam_update
    from pinns_tpu_torch.train import trainer as tr

    rho = problem.exp.loss.rho if state.rho is None else state.rho
    g_plain, aux = plain_gradient(problem, state.params, state.colloc, state.admm, rho=rho)
    p64 = tr.build_problem(override(problem.exp, {"model.dtype": "float64"}), "cuda")
    g64, _ = plain_gradient(p64, state.params, state.colloc, state.admm, torch.float64, rho=rho)
    m = dict(zip(tr.METRIC_KEYS, host(r["metrics"])))
    # a term is held at the loss's absolute accuracy: once ADMM has converged
    # res_term is a sum of squares of cancelling differences
    rows = {k: close("loss", m[k], aux[k], scale=aux["loss"])
            for k in ("loss", "data_term", "res_term")}
    rows["grad"] = close_grad(host(r["grad"]), host(g_plain), problem.spec.layers, host(g64))
    upd, adam = adam_update(r["grad"], AdamState(state.opt_state.count,
                                                 pack_params(state.opt_state.mu["net"]),
                                                 pack_params(state.opt_state.nu["net"])), lr)
    rows["adam_params"] = close("adam", host(r["params"]),
                                host(pack_params(state.params["net"]) + upd))
    rows["adam_mu"] = close("adam", host(r["mu"]), host(adam.mu))
    rows["adam_nu"] = close("adam", host(r["nu"]), host(adam.nu))
    new_net = k_fused.unpack_params(r["params"], problem.spec.layers)
    admm_new, colloc_new, _, mis = tr._post_update(
        problem, dict(state.params, net=new_net), state.admm, state.colloc, state.key,
        state.rho, state.epoch, plain=True)
    rows["colloc"] = close("colloc", host(r["colloc"]), host(colloc_new))
    rows["z"] = close("z", host(r["z"]), host(admm_new.z))
    rows["dual"] = close("dual", host(r["dual"]), host(admm_new.dual),
                         scale=float(state.admm.dual.abs().max() + rho * admm_new.z.abs().max()))
    rows["admm_misfit"] = close("admm_misfit", m["admm_misfit"], float(mis),
                                scale=float(admm_new.z.abs().max()))
    return rows


def phase_step_kernel(card: str) -> dict:
    """7: the fused step kernel against the plain step on the card."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params
    from pinns_tpu_torch.opt.adam import AdamState, adam_update
    from pinns_tpu_torch.train import trainer as tr

    def call(problem, state, want_grad=True):
        exp = problem.exp
        admm = state.admm
        return k_fused.fused_adam_step(
            problem.spec, pack_params(state.params["net"]),
            pack_params(state.opt_state.mu["net"]), pack_params(state.opt_state.nu["net"]),
            state.opt_state.count, problem.x_data, problem.targets["u"].contiguous(),
            state.colloc, admm.z if admm is not None else None,
            admm.dual if admm is not None else None, kind=exp.loss.residual_kind,
            lam1=exp.pde.lambda1, lam2=exp.pde.lambda2, rho=exp.loss.rho,
            lr=exp.optimizer.learning_rate, explicit_inner=exp.loss.explicit_inner,
            seed=state.key, epoch=state.epoch + 1, want_grad=want_grad)

    out = {}
    # -- abgrall_admm at its shape, from a state three plain steps in
    trainer = tr.Trainer(get_preset("abgrall_admm"), device="cuda")
    problem = trainer.problem
    lr = trainer.learning_rate
    state = trainer.init_state(seed=11)
    plain_step = tr.make_adam_step(problem, lr, plain=True)
    for _ in range(3):
        state, _ = plain_step(state)
    before = k_fused.LAUNCHES
    r = call(problem, state)
    again = call(problem, state)
    torch.cuda.synchronize()
    check(k_fused.LAUNCHES == before + 2, "LAUNCHES does not count the step calls")
    check(all(torch.equal(r[k], again[k]) for k in ("params", "mu", "nu", "colloc", "z",
                                                    "dual", "metrics", "grad")),
          "two calls of one step differ")
    rows = hold_narrow_step(problem, lr, state, r)
    pts = host(r["colloc"]).astype(np.float64)
    lb, ub = np.asarray(problem.spec.lb), np.asarray(problem.spec.ub)
    check(bool(((pts >= lb) & (pts < ub)).all()), "drawn points outside [lb, ub)")
    mean, var, n = (lb + ub) / 2, (ub - lb) ** 2 / 12, pts.shape[0]
    check(bool((np.abs(pts.mean(0) - mean) <= 4 * np.sqrt(var / n)).all()), "point mean")
    check(bool((np.abs(pts.var(0) - var) <= 4 * var * np.sqrt(0.8 / n)).all()), "point variance")
    out["grad_err"] = rows["grad"]["max_abs_err"]
    out["plan"] = k_fused.step_plan(problem.spec.layers, problem.exp.sampling.n_f,
                                    problem.exp.data.n_u)
    emit(card, phase="step-kernel", preset="abgrall_admm", net="8x20", n_f=problem.exp.sampling.n_f,
         n_u=problem.exp.data.n_u, criterion="STEP_TOL vs plain step", rows=rows,
         plan=dataclasses.asdict(out["plan"]), bitwise_repeatable=True,
         launches=k_fused.LAUNCHES - before)
    out["narrow"] = (trainer, state)

    # -- the wide design at 8x200 against the float64 plain step: abgrall_l1
    # (l1_sq_norm) and abgrall_admm with the wide net (z, dual and misfit).
    # abgrall_l1's grid is not committed: both train on TwoSin's
    out["wide_grad_err"] = 0.0
    for preset, updates, seed in (("abgrall_l1", {}, 12),
                                  ("abgrall_admm", {"model.layers": WIDE}, 13)):
        exp = override(get_preset(preset), updates)
        wide = tr.Trainer(exp, device="cuda", dataset="twosin_burgers_shock")
        problem, lr = wide.problem, wide.learning_rate
        check(k_fused.design(problem.spec.layers) == "wide", f"{preset}: not the wide design")
        ws = wide.init_state(seed=seed)
        before = k_fused.LAUNCHES
        r = call(problem, ws)
        again = call(problem, ws)
        torch.cuda.synchronize()
        check(k_fused.LAUNCHES == before + 2, "LAUNCHES does not count the step calls")
        check(all(torch.equal(r[k], again[k]) for k in r if r[k] is not None),
              f"{preset} at 8x200: two calls of one step differ")
        p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda",
                               dataset="twosin_burgers_shock")
        g64, aux64 = plain_gradient(p64, ws.params, ws.colloc, ws.admm, torch.float64)
        g32, aux32 = plain_gradient(problem, ws.params, ws.colloc, ws.admm)
        rows = {}
        for name, got, plain, exact in zip(
                [f"leaf{i}" for i in range(2 * (len(WIDE) - 1))],
                split_leaves(host(r["grad"]), WIDE), split_leaves(host(g32), WIDE),
                split_leaves(host(g64), WIDE)):
            rows[name] = compare_f64(name, got, plain, exact)
        m = dict(zip(tr.METRIC_KEYS, host(r["metrics"])))
        rows["loss"] = compare_f64("loss", m["loss"], aux32["loss"], aux64["loss"])
        opt = ws.opt_state
        mu, nu = pack_params(opt.mu["net"]), pack_params(opt.nu["net"])
        upd, adam = adam_update(r["grad"], AdamState(opt.count, mu, nu), lr)
        rows["adam_params"] = close_adam_params(host(r["params"]),
                                                host(pack_params(ws.params["net"]) + upd), lr)
        rows["adam_mu"] = close("adam", host(r["mu"]), host(adam.mu))
        rows["adam_nu"] = close("adam", host(r["nu"]), host(adam.nu))
        new_net = k_fused.unpack_params(r["params"], WIDE)
        admm_new, colloc_new, _, mis = tr._post_update(
            problem, dict(ws.params, net=new_net), ws.admm, ws.colloc, ws.key, None, ws.epoch,
            plain=True)
        rows["colloc"] = close("colloc", host(r["colloc"]), host(colloc_new))
        if ws.admm is not None:
            rows["z"] = close("z", host(r["z"]), host(admm_new.z))
            rows["dual"] = close("dual", host(r["dual"]), host(admm_new.dual),
                                 scale=float(ws.admm.dual.abs().max()
                                             + problem.exp.loss.rho * admm_new.z.abs().max()))
            rows["admm_misfit"] = close("admm_misfit", m["admm_misfit"], float(mis),
                                        scale=float(admm_new.z.abs().max()))
        err = float(np.abs(host(r["grad"]).astype(np.float64) - host(g32)).max())
        out["wide_grad_err"] = max(out["wide_grad_err"], err)
        emit(card, phase="step-kernel", preset=preset, net="8x200", design="wide",
             criterion="f64_oracle (gradient, loss); STEP_TOL vs plain step (Adam, points, "
                       "z, dual, misfit)",
             rows={k: rows[k] for k in rows if not k.startswith("leaf")
                   or k in ("leaf0", "leaf1", "leaf14", "leaf16", "leaf17")},
             worst_ratio=max(v["max_abs_err_vs_f64"] / max(v["plain_err_vs_f64"], 1e-30)
                             for k, v in rows.items() if k.startswith("leaf")),
             grad_max_abs_err_vs_plain=err, plan=dataclasses.asdict(
                 k_fused.step_plan(WIDE, problem.exp.sampling.n_f, problem.exp.data.n_u)),
             bitwise_repeatable=True, launches=k_fused.LAUNCHES - before)
        if preset == "abgrall_l1":
            out["wide"] = (wide, ws)
    return out


def phase_train_wide(card: str) -> dict:
    """9b: abgrall_l1's 8x200 net trained through the wide K3 (on the TwoSin
    grid, its own not being committed) for WIDE_EPOCHS epochs."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        exp = override(get_preset("abgrall_l1"), {
            "train.epochs": WIDE_EPOCHS, "train.log_every": 50, "train.out_dir": tmp})
        trainer = Trainer(exp, device="cuda", dataset="twosin_burgers_shock")
        check(k_fused.design(trainer.problem.spec.layers) == "wide", "not the wide design")
        reset_counts()
        with PlainCalls() as plain:
            t0 = time.perf_counter()
            state, _ = trainer.train(epochs=1)  # the first epoch on its own: its loss
            state, summary = trainer.train(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = kernel_counts()
        with open(os.path.join(tmp, "abgrall_l1_metrics.jsonl")) as f:
            logs = [r for r in (json.loads(line) for line in f) if "summary" not in r]
    check(counts["fused_step"] + counts["fused_chunk_epochs"] == WIDE_EPOCHS
          and counts["fused_chunk_epochs"] == WIDE_EPOCHS,
          f"K3 in {WIDE_EPOCHS} epochs: {counts['fused_step']} host calls, "
          f"{counts['fused_chunk_epochs']} replayed epochs")
    check(plain.calls == 0, f"{plain.calls} calls of a plain version")
    check(all(math.isfinite(v) for r in logs for v in r.values() if isinstance(v, float)),
          "non-finite metrics")
    check(all(bool(torch.isfinite(p).all()) for layer in state.params["net"] for p in layer.values()),
          "non-finite params")
    first, last = logs[0], logs[-1]
    check(first["epoch"] == 1 and last["epoch"] == WIDE_EPOCHS, "log epochs")
    check(last["loss"] < first["loss"], f"loss did not fall: {first['loss']} -> {last['loss']}")
    emit(card, phase="train-wide", preset="abgrall_l1", net="8x200", dataset="twosin_burgers_shock",
         epochs=WIDE_EPOCHS, wall_s=wall, loss=[first["loss"], last["loss"]],
         rel_l2_u=summary["rel_l2_u"], launches=counts, plain_calls=plain.calls)
    # on its own grid, committed since (scripts/make_torch_abgrall_grid.py)
    exp = override(get_preset("abgrall_l1"), {"train.epochs": ABGRALL_EPOCHS,
                                              "train.log_every": 0})
    trainer = Trainer(exp, device="cuda")
    check(trainer.problem.dataset.name == "abgrall_burgers_shock"
          and trainer.problem.dataset.provenance == "native", "abgrall_l1's grid")
    reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        state, own = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    own_counts = kernel_counts()
    check(own_counts["fused_chunk_epochs"] == ABGRALL_EPOCHS and own_counts["fused_step"] == 0
          and plain.calls == 0,
          f"abgrall_l1 on its grid: launches {own_counts}, {plain.calls} plain calls")
    check(math.isfinite(own["rel_l2_u"]) and all(
        bool(torch.isfinite(p).all()) for layer in state.params["net"] for p in layer.values()),
        "abgrall_l1 on its grid: non-finite result")
    emit(card, phase="train-wide", preset="abgrall_l1", net="8x200",
         dataset="abgrall_burgers_shock", epochs=ABGRALL_EPOCHS, wall_s=wall,
         rel_l2_u=own["rel_l2_u"], truth=own["truth"], launches=own_counts,
         plain_calls=plain.calls)
    return {"launches": counts["fused_step"] + counts["fused_chunk_epochs"]}


def phase_train_slice(card: str) -> None:
    """8: the committed JAX fixture replayed step by step through the kernel."""
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.train import trainer as tr

    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.losses.admm import ADMMState

    with np.load(STEPS_FIXTURE, allow_pickle=False) as z:
        fx = {k: z[k] for k in z.files}
    exp = get_preset("abgrall_admm")
    problem = tr.build_problem(exp, "cuda")
    p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
    check(tuple(int(w) for w in fx["layers"]) == problem.spec.layers, "fixture widths")
    check(np.array_equal(host(problem.x_data), fx["x_data"])
          and np.array_equal(host(problem.targets["u"]), fx["u_data"]),
          "the port's N_u training set differs from JAX's")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(problem.device)  # noqa: E731
    lr = exp.optimizer.learning_rate
    steps = []
    for k in range(int(len([n for n in fx if n.startswith("metrics_")]))):
        r = k_fused.fused_adam_step(
            problem.spec, t(fx[f"params_{k}"]), t(fx[f"mu_{k}"]), t(fx[f"nu_{k}"]),
            int(fx[f"count_{k}"]), problem.x_data, problem.targets["u"].contiguous(),
            t(fx[f"colloc_{k}"]), t(fx[f"z_{k}"]), t(fx[f"dual_{k}"]), kind="admm",
            lam1=exp.pde.lambda1, lam2=exp.pde.lambda2, rho=exp.loss.rho, lr=lr,
            explicit_inner=False, seed=0, epoch=k + 1, new_colloc=t(fx[f"colloc_{k + 1}"]),
            want_grad=(k == 0))
        m = dict(zip(tr.METRIC_KEYS, host(r["metrics"])))
        want = dict(zip(tr.METRIC_KEYS, fx[f"metrics_{k + 1}"]))
        rows = {n: close("loss", m[n], want[n], scale=abs(float(want["loss"])))
                for n in ("loss", "data_term", "res_term")}
        # mean|f - z| cancels terms of size |z|: its rounding scales with max|z|
        rows["admm_misfit"] = close("admm_misfit", m["admm_misfit"], want["admm_misfit"],
                                    scale=float(np.abs(fx[f"z_{k + 1}"]).max()))
        # the float64 plain gradient at JAX's state k: the oracle for sums
        # that cancel (close_grad)
        net_k = k_fused.unpack_params(t(fx[f"params_{k}"]), problem.spec.layers)
        coeffs = {n: torch.full((1,), float(fx[n]), device=problem.device)
                  for n in ("lambda1", "lambda2")}
        g64, _ = plain_gradient(p64, {"net": net_k, "coeffs": coeffs}, t(fx[f"colloc_{k}"]),
                                ADMMState(z=t(fx[f"z_{k}"]), dual=t(fx[f"dual_{k}"])),
                                torch.float64)
        g64 = host(g64)
        if k == 0:
            rows["grad_0"] = close_grad(host(r["grad"]), fx["grad_0"], problem.spec.layers, g64)
        rows["params"] = close_adam_params(host(r["params"]), fx[f"params_{k + 1}"], lr)
        rows["mu"] = close_grad(host(r["mu"]), fx[f"mu_{k + 1}"], problem.spec.layers,
                                0.9 * fx[f"mu_{k}"].astype(np.float64) + 0.1 * g64)
        rows["z"] = close("z", host(r["z"]), fx[f"z_{k + 1}"])
        rows["dual"] = close("dual", host(r["dual"]), fx[f"dual_{k + 1}"],
                             scale=float(np.abs(fx[f"dual_{k}"]).max()
                                         + exp.loss.rho * np.abs(fx[f"z_{k + 1}"]).max()))
        check(np.array_equal(host(r["colloc"]), fx[f"colloc_{k + 1}"]), "given points not kept")
        steps.append(rows)
    emit(card, phase="train-slice", preset="abgrall_admm", seed=int(fx["seed"]),
         steps=len(steps), per_step=steps)


def phase_train(card: str) -> dict:
    """9: abgrall_admm trained on the kernel through Trainer.train."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.train.trainer import Trainer

    with np.load(STEPS_FIXTURE, allow_pickle=False) as z:
        band_rel, band_epochs = z["band_rel_l2"], int(z["band_epochs"])
    check(band_epochs == TRAIN_EPOCHS, f"fixture band at {band_epochs} epochs")
    band = (float(band_rel.min()) - BAND_MARGIN, float(band_rel.max()) + BAND_MARGIN)
    with tempfile.TemporaryDirectory() as tmp:
        exp = override(get_preset("abgrall_admm"), {
            "train.epochs": TRAIN_EPOCHS, "train.log_every": 1000, "train.out_dir": tmp})
        trainer = Trainer(exp, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        state, _ = trainer.train(epochs=1)  # the first epoch on its own: its misfit and loss
        state, summary = trainer.train(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        launches, t2_launches = counts["fused_step"], counts["taylor2"]
        graph_epochs, replays = counts["fused_chunk_epochs"], counts["fused_chunk_replays"]
        with open(os.path.join(tmp, "abgrall_admm_metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    logs = [r for r in records if "summary" not in r]
    # K9: every Adam epoch inside a replay of the captured graphs; K3 makes no
    # host call of its own (the warm-up and the capture count in neither)
    check(launches + graph_epochs == TRAIN_EPOCHS and graph_epochs == TRAIN_EPOCHS,
          f"K3: {launches} host calls and {graph_epochs} replayed epochs in {TRAIN_EPOCHS}")
    check(t2_launches > 0, "the train path never launched the taylor2 kernel")
    check(all(math.isfinite(v) for r in logs for v in r.values() if isinstance(v, float)),
          "non-finite metrics")
    check(all(bool(torch.isfinite(p).all()) for layer in state.params["net"] for p in layer.values()),
          "non-finite params")
    first, last = logs[0], logs[-1]
    check(first["epoch"] == 1 and last["epoch"] == TRAIN_EPOCHS, "log epochs")
    check(last["loss"] < first["loss"], f"loss did not fall: {first['loss']} -> {last['loss']}")
    check(last["admm_misfit"] < first["admm_misfit"],
          f"ADMM misfit did not fall: {first['admm_misfit']} -> {last['admm_misfit']}")
    rel = summary["rel_l2_u"]
    check(band[0] <= rel <= band[1], f"u rel-L2 {rel} outside the JAX band {band}")
    emit(card, phase="train", preset="abgrall_admm", epochs=TRAIN_EPOCHS, wall_s=wall,
         loss=[first["loss"], last["loss"]], admm_misfit=[first["admm_misfit"], last["admm_misfit"]],
         rel_l2_u=rel, band=list(band), jax_seeds=band_rel.tolist(),
         fused_step_host_calls=launches, fused_chunk_epochs=graph_epochs,
         fused_chunk_replays=replays, taylor2_launches=t2_launches, summary=summary)
    return {"launches": launches + graph_epochs, "replays": replays, "state": state,
            "loss": last["loss"]}


def phase_step_times(card: str, nets: dict) -> dict:
    """times: ms per epoch of the kernel step and the plain step, and wall
    time of a 1,000-epoch chunk on the kernel, for each net."""
    from pinns_tpu_torch.train import trainer as tr

    out = {}
    for net, (trainer, state) in nets.items():
        kernel_step = trainer._adam_step
        plain_step = tr.make_adam_step(trainer.problem, trainer.learning_rate, plain=True)
        ms = event_ms(lambda: kernel_step(state))
        plain = event_ms(lambda: plain_step(state))
        emit(card, phase="times", what="train_epoch", net=net, n_f=trainer.exp.sampling.n_f,
             kernel_ms=ms, plain_ms=plain, reps=REPS, clock="cuda_events",
             bound_ms=step_bound(trainer.problem.spec.layers, trainer.exp.sampling.n_f,
                                 trainer.exp.data.n_u)[0])
        out[net] = (ms, plain)
    for net, (trainer, state) in nets.items():
        tr.run_chunk(trainer._adam_step, state, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_chunk(trainer._adam_step, state, 1000)
        torch.cuda.synchronize()
        chunk = time.perf_counter() - t0
        emit(card, phase="times", what="train_chunk", net=net, epochs=1000, wall_s=chunk,
             epochs_per_s=1000 / chunk, clock="host")
    return out


class PlainCalls:
    """Counts calls of the plain versions of the kernels while active: it
    wraps them where the port looks them up (their modules and the
    trainer's namespace). ``sites`` ((module, name) pairs) counts other
    functions instead (phase 14: the torch Philox draw)."""

    def __init__(self, sites=None):
        if sites is not None:
            self.sites, self.calls = list(sites), 0
            return
        from pinns_tpu_torch.models import mlp
        from pinns_tpu_torch.ops import taylor, weakform
        from pinns_tpu_torch.ops.kernels import ensemble as k_ensemble
        from pinns_tpu_torch.ops.kernels import fused_step, mlp_forward, taylor1, taylor2
        from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
        from pinns_tpu_torch.ops.kernels import sampling as k_sampling
        from pinns_tpu_torch.ops.kernels import weakform as k_weakform
        from pinns_tpu_torch.train import trainer

        self.sites = [(m, name) for name, mods in (
            ("mlp_apply_reference", (mlp, trainer, weakform)),
            ("path_streams", (mlp,)),
            ("fourier_streams", (mlp,)),
            ("mlp_taylor_2_reference", (taylor, trainer)),
            ("mlp_taylor_1_reference", (taylor, trainer, weakform)),
            ("mlp_backward_reference", (mlp_forward,)),
            ("taylor2_backward_reference", (taylor2, fused_step)),
            ("taylor1_backward_reference", (taylor1,)),
            ("edge_points_reference", (weakform,)),
            ("burgers_quadrature_reference", (weakform,)),
            ("euler_quadrature_reference", (weakform,)),
            ("flux_backward_reference", (k_weakform,)),
            ("taylor2_members_reference", (taylor2,)),
            ("member_stats_reference", (k_ensemble,)),
            ("value_and_grad_reference", (fused_step,)),
            ("post_update_reference", (fused_step,)),
            ("reset_reference", (k_lbfgs,)),
            ("control_reference", (k_lbfgs,)),
            ("direction_reference", (k_lbfgs,)),
            ("philox_draw_reference", (k_sampling, trainer)),
            # the host loop, K10's algorithm as the CPU runs it
            ("lbfgs_minimize", (trainer,)),
        ) for m in mods]
        self.calls = 0

    def __enter__(self):
        self.saved = [getattr(m, name) for m, name in self.sites]

        def counted(fn):
            def wrapper(*args, **kwargs):
                self.calls += 1
                return fn(*args, **kwargs)
            return wrapper

        for (m, name), fn in zip(self.sites, self.saved):
            setattr(m, name, counted(fn))
        return self

    def __exit__(self, *exc):
        for (m, name), fn in zip(self.sites, self.saved):
            setattr(m, name, fn)


def kernel_counts() -> dict:
    """The launch counts of every kernel wrapper, by kernel name."""
    from pinns_tpu_torch.ops.kernels import ensemble as k_ensemble
    from pinns_tpu_torch.ops.kernels import fused_step, mlp_forward, taylor1, taylor2, weakform
    from pinns_tpu_torch.ops.kernels import generic_chunk as k_generic
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.ops.kernels import sampling as k_sampling
    from pinns_tpu_torch.ops.kernels import fv_solve as k_fv
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs

    return {"taylor2": taylor2.LAUNCHES, "philox_draw": k_sampling.LAUNCHES,
            "generic_chunk_replays": k_generic.GRAPH_REPLAYS,
            "generic_chunk_epochs": k_generic.GRAPH_EPOCHS,
            "generic_chunk_captures": k_generic.CAPTURES, "taylor2_members": taylor2.MEMBER_LAUNCHES,
            "member_stats": k_ensemble.LAUNCHES, "fused_step": fused_step.LAUNCHES,
            "fused_step_ensemble": fused_step.ENSEMBLE_LAUNCHES,
            "fused_chunk_replays": fused_step.GRAPH_REPLAYS,
            "fused_chunk_epochs": fused_step.GRAPH_EPOCHS,
            "mlp_forward": mlp_forward.LAUNCHES, "mlp_backward": mlp_forward.BACKWARD_LAUNCHES,
            "taylor2_backward": taylor2.BACKWARD_LAUNCHES,
            "taylor2_mixed": taylor2.MIXED_LAUNCHES,
            "taylor2_mixed_backward": taylor2.MIXED_BACKWARD_LAUNCHES,
            "taylor1": taylor1.LAUNCHES, "taylor1_backward": taylor1.BACKWARD_LAUNCHES,
            "taylor1_narrow": taylor1.NARROW_LAUNCHES,
            "taylor1_narrow_backward": taylor1.NARROW_BACKWARD_LAUNCHES,
            "weakform_edge_points": weakform.EDGE_LAUNCHES, "weakform_flux": weakform.LAUNCHES,
            "weakform_flux_backward": weakform.BACKWARD_LAUNCHES,
            "weakform_flux_entropy": weakform.ENTROPY_LAUNCHES,
            "weakform_flux_entropy_backward": weakform.ENTROPY_BACKWARD_LAUNCHES,
            "fused_value_and_grad": fused_step.VALUE_AND_GRAD_LAUNCHES,
            "lbfgs_reset": k_lbfgs.RESET_LAUNCHES, "lbfgs_control": k_lbfgs.CONTROL_LAUNCHES,
            "lbfgs_direction": k_lbfgs.DIRECTION_LAUNCHES,
            "lbfgs_loop_launches": k_lbfgs.LOOP_LAUNCHES, "lbfgs_loop_steps": k_lbfgs.LOOP_STEPS,
            "lbfgs_steps_after_end": k_lbfgs.STEPS_AFTER_END,
            "lbfgs_solves": k_lbfgs.SOLVES, "lbfgs_host_syncs": host_lbfgs.HOST_SYNCS,
            "fused_post_update": fused_step.POST_UPDATE_LAUNCHES,
            "lbfgs_chunk_epochs": k_lbfgs.CHUNK_EPOCHS,
            # the float64 modes (phase 46: polish)
            "taylor2_f64": taylor2.F64_LAUNCHES,
            "taylor2_backward_f64": taylor2.F64_BACKWARD_LAUNCHES,
            "mlp_forward_f64": mlp_forward.F64_LAUNCHES,
            "mlp_backward_f64": mlp_forward.F64_BACKWARD_LAUNCHES,
            "lbfgs_reset_f64": k_lbfgs.RESET_F64_LAUNCHES,
            "lbfgs_control_f64": k_lbfgs.CONTROL_F64_LAUNCHES,
            "lbfgs_direction_f64": k_lbfgs.DIRECTION_F64_LAUNCHES,
            # the data generators (phase 48)
            "fv_burgers": k_fv.BURGERS_LAUNCHES, "fv_euler": k_fv.EULER_LAUNCHES}


def reset_counts() -> None:
    from pinns_tpu_torch.ops.kernels import ensemble as k_ensemble
    from pinns_tpu_torch.ops.kernels import fused_step, mlp_forward, taylor1, taylor2, weakform
    from pinns_tpu_torch.ops.kernels import generic_chunk as k_generic
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.ops.kernels import sampling as k_sampling
    from pinns_tpu_torch.ops.kernels import fv_solve as k_fv
    from pinns_tpu_torch.opt import lbfgs as host_lbfgs

    k_sampling.LAUNCHES = 0
    k_generic.GRAPH_REPLAYS = k_generic.GRAPH_EPOCHS = k_generic.CAPTURES = 0
    taylor2.LAUNCHES = taylor2.BACKWARD_LAUNCHES = taylor2.MEMBER_LAUNCHES = 0
    k_ensemble.LAUNCHES = 0
    taylor2.MIXED_LAUNCHES = taylor2.MIXED_BACKWARD_LAUNCHES = 0
    fused_step.LAUNCHES = fused_step.ENSEMBLE_LAUNCHES = 0
    fused_step.GRAPH_REPLAYS = fused_step.GRAPH_EPOCHS = 0
    mlp_forward.LAUNCHES = mlp_forward.BACKWARD_LAUNCHES = 0
    taylor1.LAUNCHES = taylor1.BACKWARD_LAUNCHES = 0
    taylor1.NARROW_LAUNCHES = taylor1.NARROW_BACKWARD_LAUNCHES = 0
    weakform.EDGE_LAUNCHES = weakform.LAUNCHES = weakform.BACKWARD_LAUNCHES = 0
    weakform.ENTROPY_LAUNCHES = weakform.ENTROPY_BACKWARD_LAUNCHES = 0
    fused_step.VALUE_AND_GRAD_LAUNCHES = 0
    k_lbfgs.RESET_LAUNCHES = k_lbfgs.CONTROL_LAUNCHES = k_lbfgs.DIRECTION_LAUNCHES = 0
    k_lbfgs.LOOP_LAUNCHES = k_lbfgs.LOOP_STEPS = k_lbfgs.STEPS_AFTER_END = 0
    k_lbfgs.SOLVES = host_lbfgs.HOST_SYNCS = 0
    fused_step.POST_UPDATE_LAUNCHES = k_lbfgs.CHUNK_EPOCHS = 0
    taylor2.F64_LAUNCHES = taylor2.F64_BACKWARD_LAUNCHES = 0
    mlp_forward.F64_LAUNCHES = mlp_forward.F64_BACKWARD_LAUNCHES = 0
    k_lbfgs.RESET_F64_LAUNCHES = k_lbfgs.CONTROL_F64_LAUNCHES = k_lbfgs.DIRECTION_F64_LAUNCHES = 0
    k_fv.BURGERS_LAUNCHES = k_fv.EULER_LAUNCHES = 0


def net_f64(params):
    return [{k: v.double() for k, v in p.items()} for p in params]


def flat_np(grads) -> np.ndarray:
    return np.concatenate([host(g).ravel() for g in grads]).astype(np.float64)


def phase_mlp_kernels(card: str, nets: dict) -> dict:
    """10: K5 forward and backward against their plain versions."""
    from pinns_tpu_torch.models.mlp import mlp_apply_reference
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp

    out = {}
    for layers, n in K5_SHAPES:
        spec, params = nets[layers]
        spec64 = dataclasses.replace(spec, dtype=torch.float64)
        x = points(n, seed=n + 1, device="cuda")
        # a seeded cotangent at the scale of a mean over the points
        rng = np.random.default_rng(n + 2)
        g = torch.from_numpy((rng.standard_normal((n, layers[-1])) / n).astype(np.float32)).cuda()
        with torch.no_grad():
            u = k_mlp.mlp_forward(spec, params, x)
            grad = k_mlp.mlp_backward(spec, params, x, g)
            again = k_mlp.mlp_backward(spec, params, x, g)
            u_plain = mlp_apply_reference(spec, params, x)
            u64 = mlp_apply_reference(spec64, net_f64(params), x.double())
            g_plain = k_mlp.mlp_backward_reference(spec, params, x, g)
            g64 = k_mlp.mlp_backward_reference(spec64, net_f64(params), x.double(), g.double())
            torch.cuda.synchronize()
        check(torch.equal(grad, again), f"K5 backward at {n} points: two calls differ")
        net = f"{len(layers) - 2}x{max(layers)}"
        wide = k_mlp.design(layers) == "wide"
        if wide:
            fwd = compare_f64("u", host(u), host(u_plain), host(u64))
            fwd["max_abs_err"] = fwd["max_abs_err_vs_plain"]
        else:
            fwd = compare("u", host(u), host(u_plain))
        bwd = close_grad(host(grad), flat_np(g_plain), layers, flat_np(g64))
        out[(layers, n)] = (fwd["max_abs_err"], bwd["max_abs_err"])
        config = ({"forward_plan": dataclasses.asdict(k_mlp.mlp_forward_plan(layers, n)),
                   "backward_plan": dataclasses.asdict(k_mlp.mlp_backward_plan(layers, n))}
                  if wide else {"forward_config": list(k_mlp.forward_config(layers)),
                                "backward_config": list(k_mlp.backward_config(layers, n))})
        emit(card, phase="k5", net=net, out_dim=layers[-1], n=n, design=k_mlp.design(layers),
             forward=fwd, backward=bwd, bitwise_repeatable=True, **config)
    return out


def phase_taylor2_backward(card: str, nets: dict) -> dict:
    """11: K2 against autograd through the plain recurrence."""
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference

    def autograd(spec, params, x, cot):
        leaves = [t.detach().clone().requires_grad_(True) for p in params for t in p.values()]
        net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
        outs = mlp_taylor_2_reference(spec, net, x)
        return flat_np(torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(outs, cot)),
                                           leaves))

    out = {}
    for layers, n in K2_SHAPES:
        spec, params = nets[layers]
        spec64 = dataclasses.replace(spec, dtype=torch.float64)
        x = points(n, seed=n + 3, device="cuda")
        rng = np.random.default_rng(n + 4)
        cot = [torch.from_numpy((rng.standard_normal((n, 1)) / n).astype(np.float32)).cuda()
               for _ in range(4)]
        grad = k_taylor2.taylor2_backward(spec, params, x, cot)
        again = k_taylor2.taylor2_backward(spec, params, x, cot)
        plain = autograd(spec, params, x, cot)
        exact = autograd(spec64, net_f64(params), x.double(), [c.double() for c in cot])
        torch.cuda.synchronize()
        check(torch.equal(grad, again), f"K2 at {n} points: two calls differ")
        row = close_grad(host(grad), plain, layers, exact)
        out[(layers, n)] = row["max_abs_err"]
        emit(card, phase="k2", net=f"{len(layers) - 2}x{max(layers)}", n=n,
             criterion="close_grad vs autograd through the plain recurrence", grad=row,
             backward_plan=dataclasses.asdict(k_taylor2.backward_plan(layers, n)),
             bitwise_repeatable=True)
    return out


def replay_state():
    """The abgrall_admm problem, and the JAX state the L-BFGS fixture starts
    from (abgrall_admm_steps.npz, after REPLAY_STEP Adam steps)."""
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.losses.admm import ADMMState
    from pinns_tpu_torch.ops.kernels.fused_step import unpack_params
    from pinns_tpu_torch.train import trainer as tr

    with np.load(STEPS_FIXTURE, allow_pickle=False) as z:
        fx = {k: z[k] for k in z.files}
    with np.load(LBFGS_FIXTURE, allow_pickle=False) as z:
        lb = {k: z[k] for k in z.files}
    k = int(lb["replay_step"])
    problem = tr.build_problem(get_preset("abgrall_admm"), "cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    params = {"net": unpack_params(t(fx[f"params_{k}"]), problem.spec.layers),
              "coeffs": {"lambda1": torch.full((1,), float(fx["lambda1"]), device="cuda"),
                         "lambda2": torch.full((1,), float(fx["lambda2"]), device="cuda")}}
    return problem, params, t(fx[f"colloc_{k}"]), ADMMState(z=t(fx[f"z_{k}"]),
                                                              dual=t(fx[f"dual_{k}"])), fx, lb


def phase_cross_check(card: str) -> dict:
    """12: the generic loss's value and gradient (K5 + K1/K2 under autograd)
    against K3's grad kernel, at the JAX fixture's state."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels.taylor2 import pack_params
    from pinns_tpu_torch.train import trainer as tr

    problem, params, colloc, admm, fx, _ = replay_state()
    exp = problem.exp
    leaves = [t.detach().clone().requires_grad_(True) for p in params["net"] for t in p.values()]
    net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
    before = kernel_counts()
    loss, aux = tr.make_loss_fn(problem)(dict(params, net=net), colloc, admm)
    generic = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, leaves)])
    loss = loss.detach()
    flat = pack_params(params["net"])
    r = k_fused.fused_adam_step(
        problem.spec, flat, torch.zeros_like(flat), torch.zeros_like(flat), 0, problem.x_data,
        problem.targets["u"].contiguous(), colloc, admm.z, admm.dual, kind="admm",
        lam1=exp.pde.lambda1, lam2=exp.pde.lambda2, rho=exp.loss.rho, lr=1e-3,
        explicit_inner=False, seed=0, epoch=1, want_grad=True)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in kernel_counts().items()}
    check(all(used[k] == 1 for k in ("mlp_forward", "mlp_backward", "taylor2",
                                     "taylor2_backward", "fused_step")), f"launches {used}")
    p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
    g64, aux64 = plain_gradient(p64, params, colloc, admm, torch.float64)
    m = dict(zip(tr.METRIC_KEYS, host(r["metrics"])))
    rows = {"grad": close_grad(host(generic), host(r["grad"]), problem.spec.layers, host(g64)),
            "loss": close("loss", float(loss), m["loss"], scale=aux64["loss"])}
    emit(card, phase="cross-check", state=f"abgrall_admm_steps.npz step {REPLAY_STEP}",
         criterion="close_grad: generic K5+K1/K2 gradient vs K3's grad kernel", rows=rows,
         loss_generic=float(loss), loss_k3=float(m["loss"]), loss_f64=aux64["loss"],
         launches=used)
    return rows


def phase_lbfgs_replay(card: str) -> dict:
    """13: the port's lbfgs_minimize on the card from the JAX fixture's state
    against JAX's float32 result; the cost of an iteration."""
    from pinns_tpu_torch.opt import lbfgs as lb_mod
    from pinns_tpu_torch.train import trainer as tr

    problem, params, colloc, admm, _, fx = replay_state()
    cfg = problem.exp.optimizer.lbfgs
    loss_fn = tr.make_loss_fn(problem)
    x0, unravel = lb_mod.ravel_tree(params)
    check(np.array_equal(host(x0), fx["x0"]), "ravel order differs from JAX's ravel_pytree")
    fun = lambda x: loss_fn(unravel(x), colloc, admm)[0]  # noqa: E731
    solve = lambda k: lb_mod.lbfgs_minimize(  # noqa: E731
        fun, x0, max_iters=k, history=cfg.history, ftol=cfg.ftol, gtol=cfg.gtol,
        max_ls=cfg.max_ls)
    rows = {}
    x0_np = fx["x0"].astype(np.float64)
    for k in (1, 2, 5):
        res = solve(k)
        want = fx[f"x_{k}"].astype(np.float64)
        got = host(res.x).astype(np.float64)
        err = float(np.abs(got - want).max())
        step = float(np.abs(want - x0_np).max())
        bound = ITERATE_STEP_TOL * step + ITERATE_ULP_TOL * float(np.abs(want).max())
        check(err <= bound, f"L-BFGS x after {k} iterations: err {err} > {bound}")
        check(res.n_iters == int(fx[f"n_iters_{k}"]),
              f"n_iters {res.n_iters} != JAX {int(fx[f'n_iters_{k}'])}")
        f5 = float(res.f)
        rows[f"k{k}"] = {"max_abs_err": err, "bound": bound, "jax_step": step,
                         "n_iters": res.n_iters, "n_evals": [res.n_evals, int(fx[f"n_evals_{k}"])],
                         "f": close("loss", float(res.f), float(fx[f"f_{k}"]))}
    syncs = lb_mod.HOST_SYNCS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(LONG_SOLVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = lb_mod.HOST_SYNCS - syncs
    f_jax, f = float(fx[f"f_{LONG_SOLVE}"]), float(res.f)
    band = (f_jax * (1 - LONG_SOLVE_BAND), f_jax * (1 + LONG_SOLVE_BAND))
    check(band[0] <= f <= band[1], f"L-BFGS f after the long solve {f} outside {band}")
    check(f <= f5, f"the long solve ended at {f}, above the 5-iteration {f5}")
    vg = lb_mod.value_and_grad(fun)
    vg_ms = event_ms(lambda: vg(x0))
    out = {"ms_per_iter": 1e3 * wall / res.n_iters, "vg_ms": vg_ms,
           "syncs_per_iter": syncs / res.n_iters, "evals_per_iter": res.n_evals / res.n_iters}
    emit(card, phase="lbfgs-replay", rows=rows,
         long_solve={"max_iters": LONG_SOLVE, "n_iters": res.n_iters, "n_evals": res.n_evals,
                     "jax_n_iters": int(fx[f"n_iters_{LONG_SOLVE}"]),
                     "jax_n_evals": int(fx[f"n_evals_{LONG_SOLVE}"]), "f": f, "f_jax": f_jax,
                     "band": list(band), "wall_s": wall, "host_syncs": syncs},
         times={**out, "clock": "host for the iteration, cuda_events for value-and-grad"})
    return out


def phase_hybrid(card: str, adam: dict) -> dict:
    """14: phase 9's abgrall_admm state continued through Trainer.train over
    the switch: HYBRID_OUTER L-BFGS outer epochs as chunks of K10's runner
    (LBFGSChunk): each solve on K10 (K3's value-and-grad, the control and
    direction kernels, one launch of the solve's WHILE-node graph), then K3's
    post-update mode and the reset in place as one more graph, with no read
    of the device inside a chunk (one after it): no launch of K1, K5 or K2,
    no torch Philox draw, no plain call and no host loop in the L-BFGS phase
    (its counts are read after its last chunk, before the final evaluation's
    forward)."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.data import sampling
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.train import trainer as tr

    with np.load(LBFGS_FIXTURE, allow_pickle=False) as z:
        band_rel, adam_epochs, outer = z["hybrid_rel_l2"], int(z["hybrid_adam"]), int(z["hybrid_outer"])
        max_iters = int(z["hybrid_max_iters"])
    check(adam_epochs == TRAIN_EPOCHS and outer == HYBRID_OUTER, "fixture schedule")
    band = (float(band_rel.min()) - BAND_MARGIN, float(band_rel.max()) + BAND_MARGIN)
    state = adam["state"]
    check(state.epoch == TRAIN_EPOCHS, "phase 9's state")
    with tempfile.TemporaryDirectory() as tmp:
        exp = override(get_preset("abgrall_admm"), {
            "train.epochs": TRAIN_EPOCHS + HYBRID_OUTER, "optimizer.switch_epoch": TRAIN_EPOCHS,
            "optimizer.lbfgs.max_iters": max_iters, "train.log_every": 1000, "train.out_dir": tmp})
        trainer = tr.Trainer(exp, device="cuda")
        run = trainer._get_chunk("lbfgs")
        check(isinstance(getattr(run, "runner", None), k_lbfgs.LBFGSChunk),
              "abgrall_admm's L-BFGS phase is not on K10's chunk runner")
        iters, counts = [], {}

        def chunk(st, length, new_colloc=None):
            st, m = run(st, length, new_colloc)
            iters.append(m["lbfgs_iters"])
            counts.update(kernel_counts())  # the phase's counts, before the evaluation
            return st, m

        trainer._chunks["lbfgs"] = chunk
        reset_counts()
        philox = PlainCalls([(tr, "philox_uniform"), (sampling, "philox_uniform")])
        with PlainCalls() as plain, philox:
            t0 = time.perf_counter()
            state, summary = trainer.train(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts
        with open(os.path.join(tmp, "abgrall_admm_metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f if "summary" not in line]
    chunks = len(iters)
    iters = [int(v) for v in torch.cat(iters).tolist()] if iters else []
    check(plain.calls == 0, f"{plain.calls} calls of plain versions on the path")
    check(philox.calls == 0, f"{philox.calls} torch Philox draws in the L-BFGS phase")
    check(launches["fused_step"] == launches["fused_chunk_epochs"] == 0
          and adam["launches"] == TRAIN_EPOCHS, "K3's epoch launched outside the Adam phase")
    check(all(launches[k] > 0 for k in ("fused_value_and_grad", "lbfgs_control",
                                        "lbfgs_direction", "fused_post_update")),
          f"launches {launches}")
    check(launches["taylor2"] == launches["mlp_forward"] == 0,
          f"K1 or K5 launched in the L-BFGS phase: {launches}")
    check(launches["mlp_backward"] == launches["taylor2_backward"] == 0,
          f"K5's or K2's backward launched in the L-BFGS phase: {launches}")
    check(launches["lbfgs_solves"] == launches["lbfgs_chunk_epochs"]
          == launches["fused_post_update"] == launches["lbfgs_loop_launches"] == HYBRID_OUTER
          and launches["lbfgs_reset"] == HYBRID_OUTER + chunks
          and launches["lbfgs_host_syncs"] == chunks
          and launches["lbfgs_steps_after_end"] < HYBRID_OUTER * k_lbfgs.DEVICE_STEPS,
          f"K10's solves, post-updates, resets and device reads: {launches}")
    check(len(iters) == HYBRID_OUTER and state.epoch == TRAIN_EPOCHS + HYBRID_OUTER,
          f"{len(iters)} L-BFGS outer epochs")
    check(logs[-1]["phase"] == "lbfgs" and logs[-1]["lbfgs_iters"] == iters[-1], "the log")
    loss = logs[-1]["loss"]
    check(math.isfinite(loss) and loss <= adam["loss"], f"loss {adam['loss']} -> {loss}")
    rel = summary["rel_l2_u"]
    check(band[0] <= rel <= band[1], f"u rel-L2 {rel} outside the JAX band {band}")
    emit(card, phase="hybrid", preset="abgrall_admm", adam_epochs=TRAIN_EPOCHS,
         lbfgs_outer=len(iters), lbfgs_chunks=chunks, lbfgs_max_iters=max_iters,
         lbfgs_iters=iters, wall_s=wall, ms_per_lbfgs_iter=1e3 * wall / max(1, sum(iters)),
         loss=[adam["loss"], loss], admm_misfit=logs[-1]["admm_misfit"], rel_l2_u=rel,
         band=list(band), jax_seeds=band_rel.tolist(), launches=launches,
         plain_calls=plain.calls, philox_calls=philox.calls, summary=summary)
    return {"launches": launches}


def burgers_forward_band():
    """The reduced schedule of the JAX fixture's burgers_forward band, its
    seeds, and the band: the seeds' u rel-L2 widened by BF_MARGIN."""
    with np.load(LBFGS_FIXTURE, allow_pickle=False) as z:
        band_rel = z["bf_rel_l2"]
        seeds = [int(v) for v in z["band_seeds"]]
        sched = {k: int(z[f"bf_{k}"]) for k in ("adam", "schedule", "outer", "max_iters")}
    return sched, seeds, band_rel, (float(band_rel.min()) - BF_MARGIN,
                                    float(band_rel.max()) + BF_MARGIN)


def reduced_burgers_forward(sched: dict, seed=None):
    """burgers_forward at the fixture's reduced schedule through Trainer.train
    on the card (the preset's seed unless ``seed``): (trainer, state,
    summary, per-chunk logs, kernel launches, plain calls, wall seconds)."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train import trainer as tr

    with tempfile.TemporaryDirectory() as tmp:
        exp = override(get_preset("burgers_forward"), {
            "train.epochs": sched["adam"] + sched["outer"],
            "optimizer.switch_epoch": sched["adam"],
            "optimizer.schedule_epochs": sched["schedule"],
            "optimizer.lbfgs.max_iters": sched["max_iters"],
            "train.log_every": 1000, "train.out_dir": tmp,
            **({} if seed is None else {"train.seed": seed})})
        trainer = tr.Trainer(exp, device="cuda")
        state = trainer.init_state()
        reset_counts()
        with PlainCalls() as plain:
            t0 = time.perf_counter()
            state, summary = trainer.train(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernel_counts()
        with open(os.path.join(tmp, "burgers_forward_metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f if "summary" not in line]
    return trainer, state, summary, logs, launches, plain.calls, wall


def phase_burgers_forward(card: str) -> dict:
    """15: burgers_forward at a reduced schedule through Trainer.train on the
    card, for each seed of the JAX band (1234, 7, 99): the generic Adam step
    (cosine decay, the fixed anchored batch), then L-BFGS. The median of the
    three u rel-L2 must lie in the band of JAX's three seeds: a seed alone
    moves with the float32 order of the gradient's sums. Seed 1234 ends at
    0.138 with K2, 0.140 with K2 at another split of dW's sum and 0.141 with
    the plain reverse mode on the card, above the band's 0.131; an older
    per-tile K2 ended it at 0.060 (scripts/burgers_forward_seeds.py; PERF.md,
    open question 10)."""
    from pinns_tpu_torch.ops.kernels.fused_step import fused_step_supported

    sched, seeds, band_rel, band = burgers_forward_band()
    runs = []
    for seed in seeds:
        trainer, state, summary, logs, launches, plain_calls, wall = \
            reduced_burgers_forward(sched, seed)
        check(bool(fused_step_supported(trainer.exp, trainer.problem.spec)),
              "burgers_forward in K3's scope")
        check(plain_calls == 0, f"{plain_calls} calls of plain versions on the path")
        check(launches["fused_step"] == launches["fused_chunk_epochs"] == 0,
              "K3 launched outside its scope")
        check(launches["mlp_backward"] >= sched["adam"]
              and launches["taylor2_backward"] >= sched["adam"]
              and launches["generic_chunk_epochs"] == sched["adam"], f"launches {launches}")
        check(all(math.isfinite(v) for r in logs for v in r.values() if isinstance(v, float))
              and math.isfinite(summary["rel_l2_u"]), "non-finite metrics")
        check([r["phase"] for r in logs][-1] == "lbfgs" and logs[-1]["lbfgs_iters"] > 0,
              "the log")
        runs.append({"seed": seed, "rel_l2_u": summary["rel_l2_u"], "wall_s": wall,
                     "losses": [r["loss"] for r in logs], "lbfgs_iters": logs[-1]["lbfgs_iters"],
                     "launches": launches})
        if seed == seeds[0]:
            first = {"trainer": trainer, "launches": launches}
    rel = statistics.median(r["rel_l2_u"] for r in runs)
    check(band[0] <= rel <= band[1], f"median u rel-L2 {rel} outside the JAX band {band}")
    emit(card, phase="burgers_forward", schedule=sched, n_colloc=int(state.colloc.shape[0]),
         n_f=int(trainer.problem.exp.sampling.n_f), runs=runs, median_rel_l2_u=rel,
         band=list(band), jax_seeds=dict(zip(seeds, band_rel.tolist())))
    return first


def phase_slice3_times(card: str, nets: dict, bf) -> dict:
    """times: K5 and K2 against plain (CUDA events, medians), and the generic
    step against the plain step for burgers_forward."""
    from pinns_tpu_torch.models.mlp import mlp_apply_reference
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference
    from pinns_tpu_torch.train import trainer as tr

    out = {}
    for layers, n in K5_SHAPES:
        spec, params = nets[layers]
        leaves = [t.detach().clone().requires_grad_(True) for p in params for t in p.values()]
        net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
        x = points(n, seed=n + 5, device="cuda")
        g = torch.ones((n, layers[-1]), device="cuda")
        with torch.no_grad():
            fwd = event_ms(lambda: k_mlp.mlp_forward(spec, params, x))
            fwd_plain = event_ms(lambda: mlp_apply_reference(spec, params, x))
            bwd = event_ms(lambda: k_mlp.mlp_backward(spec, params, x, g))
        bwd_plain = event_ms(lambda: torch.autograd.grad(
            mlp_apply_reference(spec, net, x), leaves, g))
        out[("k5", layers, n)] = (fwd, fwd_plain, bwd, bwd_plain)
        emit(card, phase="times", what="k5", net=f"{len(layers) - 2}x{max(layers)}",
             out_dim=layers[-1], n=n, design=k_mlp.design(layers),
             forward_ms=fwd, forward_plain_ms=fwd_plain, backward_ms=bwd,
             backward_plain_ms=bwd_plain, reps=REPS, clock="cuda_events",
             forward_bound_ms=mlp_bound(layers, n)[0],
             backward_bound_ms=mlp_bound(layers, n, backward=True)[0],
             plain="mlp_apply_reference; backward by autograd through it")
    for layers, n in K2_SHAPES:
        spec, params = nets[layers]
        leaves = [t.detach().clone().requires_grad_(True) for p in params for t in p.values()]
        net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
        x = points(n, seed=n + 6, device="cuda")
        cot = [torch.ones((n, 1), device="cuda") for _ in range(4)]
        ms = event_ms(lambda: k_taylor2.taylor2_backward(spec, params, x, cot))

        def plain():
            outs = mlp_taylor_2_reference(spec, net, x)
            return torch.autograd.grad(outs, leaves, cot)

        plain_ms = event_ms(plain)
        out[("k2", layers, n)] = (ms, plain_ms)
        emit(card, phase="times", what="k2", net=f"{len(layers) - 2}x{max(layers)}", n=n,
             kernel_ms=ms, plain_ms=plain_ms, reps=REPS, clock="cuda_events",
             bound_ms=taylor2_backward_bound(layers, n)[0],
             plain="autograd through mlp_taylor_2_reference (its forward included)")
    trainer = bf["trainer"]
    state = trainer.init_state(seed=3)
    generic = trainer._adam_step
    plain_step = tr.make_adam_step(trainer.problem, trainer.learning_rate, plain=True)
    ms = event_ms(lambda: generic(state))
    plain_ms = event_ms(lambda: plain_step(state))
    out["generic_step"] = (ms, plain_ms)
    emit(card, phase="times", what="generic_step", preset="burgers_forward",
         n_colloc=int(state.colloc.shape[0]), generic_ms=ms, plain_ms=plain_ms, reps=REPS,
         clock="cuda_events")
    return out


# -- bounds: the least time an H100 could take for a kernel's work -----------

def _macs(layers):
    return [din * dout for din, dout in zip(layers[:-1], layers[1:])]


def bound(ops, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations over the peak rate of
    their type (``ops`` = [(flop, rate), ...]) and the bytes over the memory
    rate (each input read once, each output written once)."""
    t_ops = sum(f / r for f, r in ops)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def taylor2_ops(layers, n: int, quantized=(False,) * 4):
    """The products of one Taylor-2 pass, 2 FLOP a MAC for each of the four
    streams: layer 0 at the fp32 rate, the later layers of a quantized stream
    at the bf16 rate."""
    m = _macs(layers)
    out = []
    for q in quantized:
        out += [(2.0 * m[0] * n, PEAK_FP32), (2.0 * sum(m[1:]) * n, PEAK_BF16 if q else PEAK_FP32)]
    return out


def n_params(layers) -> int:
    return sum(din * dout + dout for din, dout in zip(layers[:-1], layers[1:]))


def taylor2_bound(layers, n, quantized=(False,) * 4):
    return bound(taylor2_ops(layers, n, quantized), 8 * n + 16 * n * layers[-1] + 4 * n_params(layers))


def taylor2_backward_bound(layers, n, quantized=(False,) * 4):
    """The forward recomputed (the backward gets only x and the params) plus
    dW and gH for the four streams, whose float32 cotangents make them fp32."""
    ops = taylor2_ops(layers, n, quantized) + [(2 * 8.0 * sum(_macs(layers)) * n, PEAK_FP32)]
    return bound(ops, 8 * n + 16 * n * layers[-1] + 8 * n_params(layers))


def mlp_bound(layers, n, backward=False):
    """K5: one stream's products (3x for the backward: recompute, dW, gH)."""
    flop = (3 if backward else 1) * 2.0 * sum(_macs(layers)) * n
    nbytes = 8 * n + 4 * n * layers[-1] + (8 if backward else 4) * n_params(layers)
    return bound([(flop, PEAK_FP32)], nbytes)


def step_bound(layers, n_f, n_u):
    """K3's epoch: the residual pass, its backward, the tail's pass at the new
    points, the data term forward and backward; Adam's state and the batch,
    z and dual read and written once."""
    ops = taylor2_ops(layers, n_f) * 4 + [(3 * 2.0 * sum(_macs(layers)) * n_u, PEAK_FP32)]
    nbytes = 24 * n_params(layers) + 32 * n_f + 12 * n_u
    return bound(ops, nbytes)


def narrow_grad_bound(layers, n_f, n_u, members: int = 1):
    """K3's narrow grad kernel: at the collocation points the Taylor-2
    forward, dW and gH of the four streams; at the data points the value
    stream's (all the data term needs); the params, the points, z and dual
    read once and the gradient and loss written once, a member each."""
    ops = taylor2_ops(layers, n_f) * 3 + [(3 * 2.0 * sum(_macs(layers)) * n_u, PEAK_FP32)]
    nbytes = members * (8 * n_params(layers) + 16 * n_f + 4) + 12 * n_u
    return bound([(f * members, r) for f, r in ops], nbytes)


def narrow_tail_bound(layers, n_f, members: int = 1):
    """K3's narrow tail kernel: the Taylor-2 forward at the new points; the
    new params and the dual read, the points, z, dual and the misfit written."""
    ops = taylor2_ops(layers, n_f)
    nbytes = members * (4 * n_params(layers) + 20 * n_f + 4)
    return bound([(f * members, r) for f, r in ops], nbytes)


def narrow_bound_fields(members: int) -> dict:
    """The narrow grad and tail kernels' bounds in microseconds, with what
    bounds each, at abgrall_admm's 8x20, N_f 1,000 and N_u 100."""
    grad = narrow_grad_bound(NARROW, 1_000, 100, members)
    tail = narrow_tail_bound(NARROW, 1_000, members)
    return {"grad_bound_us": 1e3 * grad[0], "grad_bound_by": grad[1],
            "tail_bound_us": 1e3 * tail[0], "tail_bound_by": tail[1]}


def policies() -> dict:
    from pinns_tpu_torch.experiments.presets import STREAM_POLICIES

    return STREAM_POLICIES


def quantized_streams(policy: str):
    """Which of (u, u_x, u_t, u_xx) a policy quantizes."""
    keep = policies()[policy].get("model.keep_streams", ())
    mixed = bool(policies()[policy])
    return (mixed and "value" not in keep, mixed, mixed, mixed and "xx" not in keep)


def mixed_spec(layers, policy: str):
    from pinns_tpu_torch.models.mlp import MLPSpec

    upd = policies()[policy]
    return MLPSpec(layers=layers, lb=LB, ub=UB,
                   compute_dtype=upd.get("model.compute_dtype"),
                   keep_streams=upd.get("model.keep_streams", ()),
                   mixed_elementwise=upd.get("model.mixed_elementwise", False))


def bound_fields(b) -> dict:
    """The kernels line's bound keys; no single PyTorch call computes any of
    these functions, so library_ms is null."""
    return {"bound_ms": b[0], "bound_by": b[1], "library_ms": None}


def close_plain(name: str, got, plain) -> float:
    """max|got - plain|, raising unless it is at most K6_PLAIN_TOL max|plain|."""
    got, plain = (np.asarray(a, np.float64) for a in (got, plain))
    check(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    err = float(np.abs(got - plain).max())
    bound = K6_PLAIN_TOL * float(np.abs(plain).max())
    check(err <= bound, f"{name}: max|K6 - plain| {err} > {bound}")
    return err


def phase_ragged(card: str) -> None:
    """3b: K1 and K6 at RAGGED_SHAPES. A point's sums do not depend on the
    other points or on its place in the grid, so a call of n < 8,191 points
    equals the same points inside an 8,191-point call bit for bit; the
    larger call is held as phases 3 and 16 hold theirs."""
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference

    for layers, n in RAGGED_SHAPES:
        params = init_mlp(MLPSpec(layers=layers, lb=LB, ub=UB),
                          torch.Generator().manual_seed(n + 3), "cuda")
        spec64 = dataclasses.replace(mixed_spec(layers, "f32"), dtype=torch.float64)
        held = max(n, 8_191)
        x = points(held, seed=held + 5, device="cuda")
        rows = {}
        for policy in ("f32",) + K6_POLICIES:
            spec = mixed_spec(layers, policy)
            with torch.no_grad():
                got = k_taylor2.taylor2(spec, params, x[:n])
                full = k_taylor2.taylor2(spec, params, x) if held > n else got
                plain = mlp_taylor_2_reference(spec, params, x)
                exact = mlp_taylor_2_reference(spec64, net_f64(params), x.double())
            torch.cuda.synchronize()
            err = 0.0
            for name, g, f, p, e in zip(STREAMS, got, full, plain, exact):
                tag = f"ragged {policy} {len(layers) - 2}x{max(layers)} N {n} {name}"
                check(torch.equal(g, f[:n]), f"{tag}: differs from the same points in {held}")
                if policy == "f32":
                    row = compare_f64(tag, host(f), host(p), host(e))
                    err = max(err, row["max_abs_err_vs_plain"])
                else:
                    compare_f64(tag, host(f), host(p), host(e), K6_FACTOR)
                    err = max(err, close_plain(tag, host(f), host(p)))
            rows[policy] = {"max_abs_err_vs_plain": err,
                            "design": k_taylor2.launch_config(layers, spec.mixed).design}
        emit(card, phase="ragged", net=f"{len(layers) - 2}x{max(layers)}", n=n, held_over=held,
             criterion="bit-equal to the same points in the held call; held call: f32 "
                       f"|K1 - f64| <= {F64_FACTOR} |plain - f64| + 1e-6 max|f64|, K6 "
                       f"|K6 - plain| <= {K6_PLAIN_TOL} max|plain| and <= {K6_FACTOR} x the "
                       "plain version's error against f64", policies=rows)


def phase_k6(card: str, nets: dict) -> dict:
    """16: K6 forward and backward against the plain mixed version on the
    same inputs, and within the TPU test's envelope against float64."""
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference

    out = {}
    for policy in K6_POLICIES:
        for layers, n in K6_SHAPES:
            _, params = nets[layers]
            spec = mixed_spec(layers, policy)
            spec64 = dataclasses.replace(mixed_spec(layers, "f32"), dtype=torch.float64)
            params64 = net_f64(params)
            x = points(n, seed=n + 7, device="cuda")
            rng = np.random.default_rng(n + 8)
            cot = [torch.from_numpy((rng.standard_normal((n, 1)) / n).astype(np.float32)).cuda()
                   for _ in range(4)]
            with torch.no_grad():
                got = k_taylor2.taylor2(spec, params, x)
                plain = mlp_taylor_2_reference(spec, params, x)
                exact = mlp_taylor_2_reference(spec64, params64, x.double())
                grad = k_taylor2.taylor2_backward(spec, params, x, cot)
                again = k_taylor2.taylor2_backward(spec, params, x, cot)
                g_plain = k_taylor2.taylor2_backward_reference(spec, params, x, cot)
                g64 = k_taylor2.taylor2_backward_reference(spec64, params64, x.double(),
                                                           [c.double() for c in cot])
            leaves = [t.detach().clone().requires_grad_(True) for p in params for t in p.values()]
            net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
            outs = mlp_taylor_2_reference(spec, net, x)
            auto = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(outs, cot)), leaves)
            torch.cuda.synchronize()
            check(torch.equal(grad, again), f"K6 backward {policy} N {n}: two calls differ")
            fwd = {}
            for name, g, p, e in zip(STREAMS, got, plain, exact):
                tag = f"K6 {policy} N {n} {name}"
                fwd[name] = compare_f64(tag, host(g), host(p), host(e), K6_FACTOR)
                fwd[name]["max_abs_err_vs_plain_bound"] = K6_PLAIN_TOL * float(p.abs().max())
                close_plain(tag, host(g), host(p))
            bwd_rows = []
            for i, (g, p, a, e) in enumerate(zip(k_taylor2.split_grad(grad, leaves), g_plain,
                                                 auto, g64)):
                tag = f"K6 backward {policy} N {n} leaf {i}"
                row = compare_f64(tag, host(g), host(a), host(e), K6_FACTOR)
                rel = float((g - a).abs().max()) / float(a.abs().max())
                check(rel <= 0.2, f"{tag}: {rel} of autograd")
                bwd_rows.append(dict(row, max_rel_vs_autograd=rel,
                                     err_vs_plain=close_plain(tag, host(g), host(p)),
                                     rel_vs_plain=float((g - p).abs().max() / p.abs().max())))
            out[(policy, layers, n)] = (max(r["max_abs_err_vs_plain"] for r in fwd.values()),
                                        max(r["err_vs_plain"] for r in bwd_rows))
            emit(card, phase="k6", policy=policy, net="8x200", n=n,
                 criterion=f"|K6 - plain| <= {K6_PLAIN_TOL} max|plain| per stream and leaf "
                           "(plain: mlp_taylor_2_reference, taylor2_backward_reference under "
                           f"the policy); |K6 - f64| <= {K6_FACTOR} |plain - f64| + 1e-6 "
                           "max|f64|; backward within 0.2 max-relative of autograd",
                 forward=fwd, backward={
                     "leaves": len(bwd_rows),
                     "max_rel_vs_plain": max(r["rel_vs_plain"] for r in bwd_rows),
                     "worst_ratio": max(r["max_abs_err_vs_f64"] / max(r["plain_err_vs_f64"], 1e-30)
                                        for r in bwd_rows),
                     "max_rel_vs_autograd": max(r["max_rel_vs_autograd"] for r in bwd_rows)},
                 bitwise_repeatable=True, policy_flags=k_taylor2.policy_flags(spec),
                 backward_plan=dataclasses.asdict(k_taylor2.backward_plan(layers, n, True)))
    return out


def draw_scale_inputs(fx):
    """The fixture's params and batches, rebuilt from its seed as
    scripts/make_torch_scale_fixture.py::draw makes them."""
    layers = [int(w) for w in fx["layers"]]
    rng = np.random.default_rng(int(fx["seed"]))
    params = []
    for din, dout in zip(layers[:-1], layers[1:]):
        std = math.sqrt(2.0 / (din + dout))
        w = std * np.clip(rng.standard_normal((din, dout)), -2.0, 2.0)
        params.append({"W": w.astype(np.float32), "b": np.zeros((1, dout), np.float32)})
    batches = [rng.uniform(fx["lb"], fx["ub"], size=(int(fx["n_f"]), 2)).astype(np.float32)
               for _ in range(int(fx["steps"]))]
    flat = np.concatenate([a.ravel() for p in params for a in (p["W"], p["b"])])
    check(float(flat.astype(np.float64).sum()) == float(fx["params_sum"])
          and float(sum(b.astype(np.float64).sum() for b in batches)) == float(fx["colloc_sum"]),
          "the scale fixture's params or batches did not rebuild from its seed")
    return params, batches


def phase_scale_replay(card: str) -> dict:
    """17: the JAX burgers_scale fixture replayed through the generic step."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.opt.adam import adam_init
    from pinns_tpu_torch.train import trainer as tr

    with np.load(SCALE_FIXTURE, allow_pickle=False) as z:
        fx = {k: z[k] for k in z.files}
    params_np, batches = draw_scale_inputs(fx)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    base = {"sampling.n_f": int(fx["n_f"]), "sampling.microbatch": int(fx["microbatch"])}
    out = {}
    for policy in SCALE_POLICIES:
        exp = override(get_preset("burgers_scale"), dict(base, **policies()[policy]))
        problem = tr.build_problem(exp, "cuda")
        check(np.array_equal(host(problem.x_data), fx["x_data"])
              and np.array_equal(host(problem.targets["u"]), fx["u_data"]),
              "the port's N_u training set differs from JAX's")
        params = {"net": [{k: t(v) for k, v in p.items()} for p in params_np],
                  "coeffs": {"lambda1": torch.full((1,), exp.pde.lambda1, device="cuda"),
                             "lambda2": torch.full((1,), exp.pde.lambda2, device="cuda")}}
        leaves = [v.clone().requires_grad_(True) for p in params["net"] for v in p.values()]
        net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
        loss0, _ = tr.make_loss_fn(problem)(dict(params, net=net), t(batches[0]), None)
        grad0 = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss0, leaves)])
        step = tr.make_adam_step(problem, exp.optimizer.learning_rate)
        state = tr.TrainState(params=params, opt_state=adam_init(params), admm=None,
                              colloc=t(batches[0]), key=0, epoch=0)
        rows = []
        for k in range(int(fx["steps"])):
            nxt = t(batches[k + 1]) if k + 1 < len(batches) else None
            state, m = step(state, new_colloc=nxt)
            got = {n: float(m[n]) for n in ("loss", "data_term", "res_term")}
            row = {}
            for n, v in got.items():
                want, f32 = float(fx[f"{policy}_{n}"][k]), float(fx[f"f32_{n}"][k])
                # a mixed run must land nearer JAX's mixed value than JAX's
                # float32 one (a run without the policy would sit on the latter)
                tol = (1e-4 * abs(want) if policy == "f32"
                       else 0.5 * abs(want - f32) + 1e-6 * abs(want))
                check(math.isfinite(v) and abs(v - want) <= tol,
                      f"scale replay {policy} step {k} {n}: {v} vs JAX {want} (tol {tol})")
                row[n] = {"port": v, "jax": want, "tol": tol}
            rows.append(row)
        g = host(grad0).astype(np.float64)
        leaves_np = split_leaves(g, WIDE)
        norms = np.array([np.linalg.norm(a) for a in leaves_np])
        norm_rel = float(np.max(np.abs(norms - fx[f"{policy}_grad_norms"])
                                / fx[f"{policy}_grad_norms"]))
        check(norm_rel <= 0.05, f"scale replay {policy}: step-0 gradient norms {norm_rel} off")
        grad_row = {"leaf_norm_max_rel": norm_rel}
        if policy == "f32":
            p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
            g64, _ = plain_gradient(p64, params, t(batches[0]), None, torch.float64)
            grad_row.update(close_grad(g.astype(np.float32), fx["f32_grad_0"], WIDE, host(g64)))
        out[policy] = rows
        emit(card, phase="scale-replay", policy=policy, n_f=int(fx["n_f"]),
             microbatch=int(fx["microbatch"]), steps=rows, grad_0=grad_row,
             criterion="f32: rtol 1e-4; mixed: |port - jax| <= 0.5 |jax - jax_f32| + 1e-6 |jax|")
    return out


def phase_burgers_scale(card: str) -> dict:
    """18: burgers_scale at full size through Trainer.train on the card."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.train import trainer as tr

    out = {}
    for policy in SCALE_POLICIES:
        with tempfile.TemporaryDirectory() as tmp:
            exp = override(get_preset("burgers_scale"), dict(policies()[policy], **{
                "train.epochs": SCALE_EPOCHS, "train.chunk": 1, "train.log_every": 1,
                "train.out_dir": tmp}))
            trainer = tr.Trainer(exp, device="cuda")
            m = exp.sampling.microbatch
            state = trainer.init_state()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with PlainCalls() as plain:
                t0 = time.perf_counter()
                state, summary = trainer.train(state)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = kernel_counts()
            peak = torch.cuda.max_memory_allocated()
            with open(os.path.join(tmp, "burgers_scale_metrics.jsonl")) as f:
                logs = [json.loads(line) for line in f if "summary" not in line]
        mixed = policy != "f32"
        fwd, bwd = ("taylor2_mixed", "taylor2_mixed_backward") if mixed else \
            ("taylor2", "taylor2_backward")
        other = ("taylor2", "taylor2_backward") if mixed else \
            ("taylor2_mixed", "taylor2_mixed_backward")
        losses = [r["loss"] for r in logs]
        check(plain.calls == 0, f"{plain.calls} calls of plain versions on the path")
        # every epoch: m forward and m backward launches; the final evaluation
        # adds one forward over the grid
        check(launches[bwd] == m * SCALE_EPOCHS and launches[fwd] == m * SCALE_EPOCHS + 1,
              f"{policy}: launches {launches}")
        check(launches["fused_step"] == launches["fused_chunk_epochs"] == 0
              and launches[other[0]] == launches[other[1]] == 0, f"{policy}: launches {launches}")
        check(launches["mlp_forward"] == launches["mlp_backward"] == SCALE_EPOCHS,
              f"{policy}: launches {launches}")
        check(len(logs) == SCALE_EPOCHS and all(math.isfinite(v) for v in losses),
              f"{policy}: losses {losses}")
        # Adam's first update moves every weight by lr and the loss jumps (the
        # fixture's JAX runs: 0.34 -> 1.32); it falls below its start by the fifth
        check(losses[-1] < losses[0], f"{policy}: the loss did not fall: {losses}")
        epoch_ms = [1e3 * r["elapsed"] for r in logs]
        out[policy] = {"ms_per_epoch": statistics.median(epoch_ms[1:]), "launches": launches,
                       "peak_bytes": peak}
        emit(card, phase="burgers_scale", policy=policy, epochs=SCALE_EPOCHS,
             n_f=exp.sampling.n_f, microbatch=m, points_per_microbatch=exp.sampling.n_f // m,
             losses=losses, ms_per_epoch=epoch_ms, ms_per_epoch_median=out[policy]["ms_per_epoch"],
             points_per_s=exp.sampling.n_f / (out[policy]["ms_per_epoch"] / 1e3),
             wall_s=wall, peak_device_bytes=peak, launches=launches, plain_calls=plain.calls,
             rel_l2_u=summary["rel_l2_u"], clock="host, per 1-epoch chunk ending in a sync",
             k6_policy_flags=k_taylor2.policy_flags(trainer.problem.spec) if mixed else None)
    return out


def phase_k6_times(card: str, nets: dict) -> dict:
    """times: K6 forward and backward against plain (CUDA events, medians)."""
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference

    out = {}
    for policy in K6_POLICIES:
        for layers, n in K6_SHAPES:
            _, params = nets[layers]
            spec = mixed_spec(layers, policy)
            leaves = [t.detach().clone().requires_grad_(True) for p in params for t in p.values()]
            net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
            x = points(n, seed=n + 9, device="cuda")
            cot = [torch.ones((n, 1), device="cuda") for _ in range(4)]
            with torch.no_grad():
                fwd = event_ms(lambda: k_taylor2.taylor2(spec, params, x))
                fwd_plain = event_ms(lambda: mlp_taylor_2_reference(spec, params, x))
                bwd = event_ms(lambda: k_taylor2.taylor2_backward(spec, params, x, cot))
            bwd_plain = event_ms(lambda: torch.autograd.grad(
                mlp_taylor_2_reference(spec, net, x), leaves, cot))
            q = quantized_streams(policy)
            fb, fb_by = taylor2_bound(layers, n, q)
            bb, bb_by = taylor2_backward_bound(layers, n, q)
            out[(policy, layers, n)] = (fwd, fwd_plain, bwd, bwd_plain, (fb, fb_by), (bb, bb_by))
            emit(card, phase="times", what="k6", policy=policy, net="8x200", n=n,
                 forward_ms=fwd, forward_plain_ms=fwd_plain, forward_bound_ms=fb,
                 backward_ms=bwd, backward_plain_ms=bwd_plain, backward_bound_ms=bb,
                 reps=REPS, clock="cuda_events",
                 plain="mlp_taylor_2_reference under the policy; backward by autograd "
                       "through it (its forward included)")
    return out


# -- 19-22 and times: the Euler strong-form slice (K7a, K5 at out_dim 3) -----

def taylor1_ops(layers, n: int):
    """The products of one Taylor-1 pass: three streams, 2 FLOP a MAC."""
    return [(3 * 2.0 * sum(_macs(layers)) * n, PEAK_FP32)]


def taylor1_bound(layers, n):
    return bound(taylor1_ops(layers, n), 8 * n + 12 * n * layers[-1] + 4 * n_params(layers))


def taylor1_backward_bound(layers, n):
    """The forward recomputed (the backward gets only x and the params), dW
    of every layer and gH of every layer but the first, for three streams."""
    m = _macs(layers)
    ops = taylor1_ops(layers, n) + [(3 * 2.0 * (sum(m) + sum(m[1:])) * n, PEAK_FP32)]
    return bound(ops, 8 * n + 12 * n * layers[-1] + 8 * n_params(layers))


def euler_fixture() -> dict:
    with np.load(EULER_FIXTURE, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def net_from_flat(flat: np.ndarray, layers) -> list:
    leaves = split_leaves(flat, layers)
    return [{"W": w.reshape(din, dout), "b": b.reshape(1, dout)}
            for w, b, din, dout in zip(leaves[0::2], leaves[1::2], layers[:-1], layers[1:])]


def k7a_net(layers, seed: int, device):
    """A seeded random net with nonzero biases (the bias rides on the value
    rows only), and its float64 twin."""
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp

    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    params = init_mlp(spec, torch.Generator().manual_seed(seed), device)
    gen = torch.Generator().manual_seed(seed + 1)
    for p in params:
        p["b"].copy_(0.1 * torch.randn(p["b"].shape, generator=gen))
    return spec, params, dataclasses.replace(spec, dtype=torch.float64), net_f64(params)


def phase_euler_serve(card: str) -> dict:
    """19: the native Euler grid against the JAX fixture, and the fixture's
    trunk served on the card (K7a) against JAX's outputs and the plain version."""
    from pinns_tpu_torch.data.datasets import load_euler_mat
    from pinns_tpu_torch.data.generators import make_abgrall_eulers_grid
    from pinns_tpu_torch.interop import params_from_jax
    from pinns_tpu_torch.models.mlp import MLPSpec
    from pinns_tpu_torch.ops.residuals import euler_combine
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1_reference
    from pinns_tpu_torch.serve import ServedModel, export_predict, make_http_server

    fx = euler_fixture()
    ds = load_euler_mat("abgrall_eulers")
    check(ds.fields["rho"].shape == (157, 300) and ds.provenance == "native",
          f"Euler grid {ds.fields['rho'].shape} {ds.provenance}")
    g = make_abgrall_eulers_grid()
    xi, ti = fx["grid_idx"][:, 0], fx["grid_idx"][:, 1]
    grid_err = max(
        [float(np.abs(g["x"].ravel() - fx["grid_x"]).max()),
         float(np.abs(g["t"].ravel() - fx["grid_t"]).max())]
        + [float(np.abs(g[key][xi, ti] - fx[f"grid_{name}"]).max())
           for name, key in zip(EULER_FIELDS, ("rhosol", "usol", "Enersol"))])
    check(grid_err <= 1e-12, f"Euler grid differs from JAX's by {grid_err}")
    layers = tuple(int(w) for w in fx["layers"])
    check(layers == EULER, f"fixture widths {layers}")
    gamma = float(fx["gamma"])
    spec = MLPSpec(layers=layers, lb=tuple(fx["lb"]), ub=tuple(fx["ub"]))
    check(spec.lb == tuple(float(v) for v in ds.lb) and spec.ub == tuple(float(v) for v in ds.ub),
          "the fixture's bounds are not the grid's")
    net = net_from_flat(fx["params_0"], layers)
    x = fx["predict_x"]
    check(np.array_equal(x, ds.X_star), "the fixture's points are not the grid's")
    with tempfile.TemporaryDirectory() as tmp:
        art = export_predict(spec, net, os.path.join(tmp, "euler"), 0.0, 0.0,
                             experiment="euler_admm", pde="euler", gamma=gamma)
        served = ServedModel(art, device="cuda")
        check(served.fields == sorted(EULER_OUT, key=str), f"fields {served.fields}")
        reset_counts()
        out = served.predict(x, pad_to_bucket=True)
        launches = kernel_counts()
        check(launches["taylor1"] == 1 and launches["taylor2"] == 0, f"launches {launches}")
        vs_jax = {k: compare(k, out[k].ravel(), fx[f"predict_{k}"]) for k in EULER_OUT}
        params = params_from_jax(net, "cuda")
        with torch.inference_mode():
            y, yx, yt = mlp_taylor_1_reference(spec, params, torch.from_numpy(x).cuda())
            fields, res = euler_combine(y, yx, yt, gamma)
        plain = dict(zip(EULER_OUT, (host(t) for t in fields + res)))
        vs_plain = {k: compare(k, out[k], plain[k]) for k in EULER_OUT}
        perm = np.random.default_rng(19).permutation(x.shape[0])
        ragged = {}
        for n in EULER_RAGGED:
            idx = perm[:n]
            o = served.predict(x[idx])
            ragged[n] = max(compare(k, o[k].ravel(), fx[f"predict_{k}"][idx])["max_abs_err"]
                            for k in EULER_OUT)
        server = make_http_server(art, port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://127.0.0.1:%d" % server.server_address[1]
            code, _, body = http(base + "/meta")
            check(code == 200 and json.loads(body)["pde"] == "euler", "GET /meta")
            x8 = x[perm[:8]]
            code, _, body = http(base + "/predict", json.dumps({"x": x8.tolist()}).encode())
            check(code == 200, f"JSON POST answered {code}: {body[:200]!r}")
            want8 = served.predict(x8, pad_to_bucket=True)
            got8 = {k: np.asarray(v, np.float32) for k, v in json.loads(body).items()}
            check(sorted(got8) == sorted(want8)
                  and all(np.array_equal(got8[k], want8[k]) for k in want8), "JSON predict")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "HTTP server thread did not stop")
        predict_ms = host_ms(lambda: served.predict(x, pad_to_bucket=True))
    emit(card, phase="euler-serve", grid=[157, 300], grid_err_vs_jax=grid_err, n=int(x.shape[0]),
         bucket=served.bucket_size(x.shape[0]), vs_jax=vs_jax, vs_plain=vs_plain,
         ragged_max_abs_err=ragged, http_points=8, launches=launches)
    emit(card, phase="times", what="served_predict", net="2x200x5x3", pde="euler",
         n=int(x.shape[0]), ms=predict_ms, points_per_s=x.shape[0] / (predict_ms / 1e3),
         reps=REPS, clock="host")
    return {"launches": launches, "predict_ms": predict_ms}


def phase_k7a(card: str) -> dict:
    """20: K7a and its backward against the plain versions on the card, each
    net of widths <= 32 through both designs, whose forwards agree bit for
    bit; two backward calls of a design agree bit for bit."""
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1_reference

    out = {}
    for layers, n in K7A_SHAPES + [K7A_NARROW_MAIN]:
        spec, params, spec64, params64 = k7a_net(layers, 207, "cuda")
        x = points(n, seed=n + 7, device="cuda")
        rng = np.random.default_rng(n + 8)
        cot = [torch.from_numpy(rng.standard_normal((n, layers[-1])).astype(np.float32)).cuda()
               for _ in range(3)]
        with torch.inference_mode():
            plain = mlp_taylor_1_reference(spec, params, x)
            exact = mlp_taylor_1_reference(spec64, params64, x.double())
            pgrad = k_taylor1.taylor1_backward_reference(spec, params, x, cot)
            egrad = k_taylor1.taylor1_backward_reference(spec64, params64, x.double(),
                                                         [c.double() for c in cot])
        wide = max(layers) > 32
        designs = ("wide",) if k_taylor1.default_design(layers) == "wide" else ("narrow", "wide")
        fwd = {}
        for design in designs:
            with torch.inference_mode():
                got = k_taylor1.taylor1(spec, params, x, design=design)
                grad = k_taylor1.taylor1_backward(spec, params, x, cot, design=design)
                again = k_taylor1.taylor1_backward(spec, params, x, cot, design=design)
            torch.cuda.synchronize()
            fwd[design] = got
            check(torch.equal(grad, again),
                  f"K7a {design} backward not repeatable at {layers}, N {n}")
            streams = {}
            for name, g, p, e in zip(("y", "y_x", "y_t"), got, plain, exact):
                streams[name] = (compare_f64(name, host(g), host(p), host(e)) if wide
                                 else compare(name, host(g), host(p)))
            leaves, off = [], 0
            for p, e in zip(pgrad, egrad):
                g = host(grad[off:off + p.numel()])
                off += p.numel()
                row = measure("k7a_grad", g, host(p).ravel())
                if wide or not row["ok"]:
                    row = dict(compare_f64("k7a_grad", g, host(p).ravel(), host(e).ravel()),
                               max_abs_err=float(np.abs(g - host(p).ravel()).max()))
                leaves.append(row)
            fwd_err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
            bwd_err = max(r["max_abs_err"] for r in leaves)
            out[(layers, n, design)] = (fwd_err, bwd_err)
            plans = [k_taylor1.taylor1_plan(layers, n, b, design=design) for b in (False, True)]
            emit(card, phase="k7a", design=design, net=f"{len(layers) - 2}x{max(layers)}",
                 out_dim=layers[-1], n=n, criterion="f64_oracle" if wide else "tol_vs_plain",
                 launches_forward=plans[0].launches, launches_backward=plans[1].launches,
                 plan=dataclasses.asdict(plans[1]), streams=streams,
                 forward_max_abs_err=fwd_err, backward_max_abs_err=bwd_err,
                 leaves_by_f64_oracle=sum("bound" in r for r in leaves), bit_equal=True)
        if len(designs) == 2:
            check(all(torch.equal(a, b) for a, b in zip(fwd["narrow"], fwd["wide"])),
                  f"K7a's narrow forward differs from its wide forward at {layers}, N {n}")
            emit(card, phase="k7a", what="narrow_vs_wide_forward",
                 net=f"{len(layers) - 2}x{max(layers)}", n=n, bit_equal=True)
    for (layers, n, design), v in list(out.items()):
        if design == k_taylor1.default_design(layers):
            out[(layers, n)] = v  # the design the widths pick
    return out


def euler_state(fx: dict, device):
    """The port's TrainState at the fixture's JAX initial state: params,
    zero Adam moments, the tuple ADMM state, JAX's first batch."""
    from pinns_tpu_torch.interop import train_state_from_jax

    layers = tuple(int(w) for w in fx["layers"])
    net = net_from_flat(fx["params_0"], layers)
    zeros = [{k: np.zeros_like(v) for k, v in layer.items()} for layer in net]
    coeffs = {"lambda1": np.ones(1, np.float32), "lambda2": np.zeros(1, np.float32)}
    zc = {k: np.zeros_like(v) for k, v in coeffs.items()}
    return train_state_from_jax({
        "params": {"net": net, "coeffs": coeffs}, "count": 0,
        "mu": {"net": zeros, "coeffs": zc}, "nu": {"net": zeros, "coeffs": zc},
        "z": tuple(v.reshape(-1, 1) for v in fx["z_0"]),
        "dual": tuple(v.reshape(-1, 1) for v in fx["dual_0"]),
        "colloc": fx["colloc_0"], "epoch": 0}, device, key=int(fx["seed"]))


def phase_euler_step(card: str) -> dict:
    """21: one euler_admm Adam step on the card against JAX's, from the
    fixture's state at its points, then the fixture's short replay."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train import trainer as tr

    fx = euler_fixture()
    layers = tuple(int(w) for w in fx["layers"])
    exp = get_preset("euler_admm")
    problem = tr.build_problem(exp, "cuda")
    p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
    check(problem.spec.layers == layers, "fixture widths")
    check(np.array_equal(host(problem.x_data), fx["x_data"])
          and all(np.array_equal(host(problem.targets[k]), fx[f"{k}_data"]) for k in EULER_FIELDS),
          "the port's IC/BC training set differs from JAX's")
    state = euler_state(fx, problem.device)
    lr, rho = exp.optimizer.learning_rate, exp.loss.rho
    params = tr.tree_map(lambda t: t.detach().clone().requires_grad_(True), state.params)
    reset_counts()
    loss, aux = tr.make_loss_fn(problem)(params, state.colloc, state.admm)
    grad = torch.autograd.grad(loss, tr.tree_leaves(params["net"]))
    torch.cuda.synchronize()
    launches = kernel_counts()
    check(launches["taylor1"] == 1 and launches["taylor1_backward"] == 1
          and launches["mlp_forward"] == 1 and launches["mlp_backward"] == 1,
          f"the loss's launches {launches}")
    g64, _ = plain_gradient(p64, state.params, state.colloc, state.admm, torch.float64)
    rows = {"loss": close("loss", float(loss.detach()), fx["loss_0"], scale=abs(float(fx["loss_0"]))),
            "grad_0": close_grad(flat_np(grad), fx["grad_0"], layers, host(g64))}
    step = tr.make_step(problem, lr)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(problem.device)  # noqa: E731
    steps = max(int(k.split("_")[1]) for k in fx if k.startswith("metrics_"))
    replay = []
    for k in range(1, steps + 1):
        z_prev = fx[f"dual_{k - 1}"]
        state, m = step(state, new_colloc=t(fx[f"colloc_{k}"]))
        m = {n: float(v) for n, v in m.items()}
        want = dict(zip(tr.METRIC_KEYS, fx[f"metrics_{k}"].tolist()))
        r = {n: close("loss", m[n], want[n], scale=abs(want["loss"]))
             for n in ("loss", "data_term", "res_term")}
        r["admm_misfit"] = close("admm_misfit", m["admm_misfit"], want["admm_misfit"],
                                 scale=float(np.abs(fx[f"z_{k}"]).max()))
        z = np.stack([host(v).ravel() for v in state.admm.z])
        dual = np.stack([host(v).ravel() for v in state.admm.dual])
        r["z"] = close("z", z, fx[f"z_{k}"])
        r["dual"] = close("dual", dual, fx[f"dual_{k}"],
                          scale=float(np.abs(z_prev).max() + rho * np.abs(fx[f"z_{k}"]).max()))
        got = [host(v).astype(np.float64) for layer in state.params["net"] for v in layer.values()]
        sums = np.asarray([(v.sum(), (v * v).sum()) for v in got])
        r["leaf_sums"] = close("leaf_sums", sums, fx[f"sums_{k}"])
        if k == 1:
            r["params"] = close_adam_params(flat_np(tr.tree_leaves(state.params["net"])),
                                            fx["params_1"], lr)
        replay.append(r)
    emit(card, phase="euler-step", preset="euler_admm", seed=int(fx["seed"]), step_0=rows,
         launches=launches, replay_steps=len(replay), per_step=replay)
    return {"grad_err": rows["grad_0"]["max_abs_err"]}


def reduced_euler(preset: str, epochs: int, seed: int):
    """``preset`` through Trainer.train on the card for ``epochs`` epochs:
    (trainer, summary, logs, launches, plain calls, wall seconds); the counts
    are set to 0 just before train and read just after."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train import trainer as tr

    with tempfile.TemporaryDirectory() as tmp:
        exp = override(get_preset(preset), {"train.epochs": epochs, "train.seed": seed,
                                            "train.log_every": 1000, "train.out_dir": tmp})
        trainer = tr.Trainer(exp, device="cuda")
        state = trainer.init_state()
        reset_counts()
        with PlainCalls() as plain:
            t0 = time.perf_counter()
            state, summary = trainer.train(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernel_counts()
        with open(os.path.join(tmp, f"{preset}_metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f if "summary" not in line]
    check(plain.calls == 0, f"{plain.calls} calls of plain versions on the path")
    # an epoch: one loss forward and backward of K7a and K5, one K7a forward
    # at the new points, one K11 draw (the initial batch is drawn before the
    # counts are reset); the evaluation one more K7a forward.
    # Every epoch runs in a replay of K9's generic graph, which counts the
    # captured epoch's launches; each capture's warm-up epoch runs them too
    n = epochs + launches["generic_chunk_captures"]
    want = {"taylor1": 2 * n + 1, "taylor1_backward": n, "mlp_forward": n,
            "mlp_backward": n, "philox_draw": n, "generic_chunk_epochs": epochs,
            "fused_step": 0, "taylor2": 0, "taylor2_backward": 0}
    check(all(launches[k] == v for k, v in want.items()), f"launches {launches}, want {want}")
    check(all(math.isfinite(v) for r in logs for v in r.values() if isinstance(v, float))
          and all(math.isfinite(summary[f"rel_l2_{f}"]) for f in EULER_FIELDS),
          "non-finite metrics")
    check(logs[-1]["loss"] < logs[0]["loss"], f"loss did not fall: {logs[0]['loss']} -> "
          f"{logs[-1]['loss']}")
    return trainer, summary, logs, launches, wall


def phase_euler_train(card: str) -> dict:
    """22: euler_admm at the fixture's reduced schedule for JAX's three band
    seeds, the median rel-L2 of each field in the band; euler_admm_tuned once
    for UNHELD_EPOCHS."""
    fx = euler_fixture()
    epochs, seeds, band_rel = int(fx["band_epochs"]), fx["band_seeds"].tolist(), fx["band_rel_l2"]
    band = {f: (float(band_rel[:, i].min()) - EULER_MARGIN,
                float(band_rel[:, i].max()) + EULER_MARGIN) for i, f in enumerate(EULER_FIELDS)}
    runs = []
    for seed in seeds:
        trainer, summary, logs, launches, wall = reduced_euler("euler_admm", epochs, seed)
        runs.append({"seed": seed, **{f: summary[f"rel_l2_{f}"] for f in EULER_FIELDS},
                     "truth": summary["truth"], "wall_s": wall, "loss": [logs[0]["loss"],
                     logs[-1]["loss"]], "launches": launches})
        if seed == seeds[0]:
            first = {"trainer": trainer, "launches": launches, "wall_s": wall}
    median = {f: statistics.median(r[f] for r in runs) for f in EULER_FIELDS}
    for f in EULER_FIELDS:
        check(band[f][0] <= median[f] <= band[f][1],
              f"median {f} rel-L2 {median[f]} outside the JAX band {band[f]}")
    _, tuned, logs, t_launches, t_wall = reduced_euler("euler_admm_tuned", UNHELD_EPOCHS,
                                                        seeds[0])
    emit(card, phase="euler-train", preset="euler_admm", epochs=epochs, runs=runs,
         median_rel_l2=median, band={f: list(b) for f, b in band.items()},
         jax_seeds={str(s): dict(zip(EULER_FIELDS, r)) for s, r in zip(seeds, band_rel.tolist())},
         tuned={"seed": seeds[0], "epochs": UNHELD_EPOCHS,
                **{f: tuned[f"rel_l2_{f}"] for f in EULER_FIELDS},
                "wall_s": t_wall, "launches": t_launches, "held": False})
    return first


def phase_euler_times(card: str, train: dict) -> dict:
    """times: the Euler epoch through the trainer's step and the plain step
    (CUDA events), a 1,000-epoch chunk, and K7a and its backward against
    autograd through the plain version."""
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1_reference
    from pinns_tpu_torch.train import trainer as tr

    trainer = train["trainer"]
    state = trainer.init_state(seed=3)
    step = trainer._adam_step
    plain_step = tr.make_adam_step(trainer.problem, trainer.learning_rate, plain=True)
    ms = event_ms(lambda: step(state))
    plain_ms = event_ms(lambda: plain_step(state))
    tr.run_chunk(step, state, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run_chunk(step, state, 1000)
    torch.cuda.synchronize()
    chunk = time.perf_counter() - t0
    emit(card, phase="times", what="euler_epoch", preset="euler_admm", epoch_ms=ms,
         plain_ms=plain_ms, reps=REPS, clock="cuda_events", chunk_epochs=1000,
         chunk_wall_s=chunk, epochs_per_s=1000 / chunk)
    out = {"epoch": (ms, plain_ms, 1000 / chunk)}
    for layers, n in K7A_TIMES:
        spec, params, _, _ = k7a_net(layers, 207, "cuda")
        leaves = [t.detach().clone().requires_grad_(True) for p in params for t in p.values()]
        net = [{"W": w, "b": b} for w, b in zip(leaves[0::2], leaves[1::2])]
        x = points(n, seed=n + 9, device="cuda")
        cot = [torch.ones((n, layers[-1]), device="cuda") for _ in range(3)]
        design = k_taylor1.default_design(layers)
        with torch.no_grad():
            fwd = event_ms(lambda: k_taylor1.taylor1(spec, params, x))
            fwd_plain = event_ms(lambda: mlp_taylor_1_reference(spec, params, x))
            bwd = event_ms(lambda: k_taylor1.taylor1_backward(spec, params, x, cot))
            # a narrow net through the wide design too, the two side by side
            other = {} if design == "wide" else {
                "wide_forward_ms": event_ms(lambda: k_taylor1.taylor1(spec, params, x,
                                                                      design="wide")),
                "wide_backward_ms": event_ms(lambda: k_taylor1.taylor1_backward(
                    spec, params, x, cot, design="wide"))}
        bwd_plain = event_ms(lambda: torch.autograd.grad(
            mlp_taylor_1_reference(spec, net, x), leaves, cot))
        out[(layers, n)] = (fwd, fwd_plain, bwd, bwd_plain)
        emit(card, phase="times", what="k7a", design=design,
             net=f"{len(layers) - 2}x{max(layers)}", n=n,
             launches_forward=k_taylor1.taylor1_plan(layers, n).launches,
             launches_backward=k_taylor1.taylor1_plan(layers, n, True).launches,
             forward_ms=fwd, forward_plain_ms=fwd_plain, backward_ms=bwd,
             backward_plain_ms=bwd_plain, **other, reps=REPS, clock="cuda_events",
             forward_bound_ms=taylor1_bound(layers, n)[0],
             backward_bound_ms=taylor1_backward_bound(layers, n)[0],
             plain="mlp_taylor_1_reference; backward by autograd through it")
    return out


# -- 23-26 and times: P2 and the weak-form slice (K7b around K7a and K5) ------

WEAK_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "weak_flux.npz")
WEAK_PRESETS = ("twosin_weak", "euler_inverse")
P2_EPOCHS = 2_000
# K7b at the presets' 1,000 cells and at 65,536, both equations, viscous and
# inviscid; the main shape is twosin_weak's (Burgers, viscous, 1,000 cells)
K7B_SHAPES = [(kind, viscous, n) for n in (1_000, 65_536) for kind in ("burgers", "euler")
              for viscous in (True, False)]
K7B_MAIN, K7B_EULER = ("burgers", True, 1_000), ("euler", True, 1_000)
K7B_TIMES = [("burgers", True, 1_000), ("euler", True, 1_000), ("burgers", True, 65_536),
             ("euler", True, 65_536)]
K7B_QUAD = 4
WEAK_EPOCHS = 3_000  # the fixture's band_epochs
WEAK_MARGIN = 0.05  # as BAND_MARGIN: three JAX seeds at the reduced schedule
# 27-29: the shock-path slice; its preset's K7a call at the edge points
# (16,000: 1,000 cells x 16) and K5 call on the data term (200 points)
PATH_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "euler_weak.npz")
PATH_PRESET = "euler_weak_fast"
PATH_NS = (200, 1_000, 16_000, 65_536)
PATH_K7A_MAIN, PATH_K5_MAIN = 16_000, 200
PATH_K7A_TIMES = (1_000, 16_000)
PATH_MARGIN = 0.05  # as BAND_MARGIN: three JAX seeds at the reduced schedule


def cli_json(argv) -> dict:
    """``python -m pinns_tpu_torch <argv>`` in this process; the JSON object
    its last output line prints (or the line itself, for a path)."""
    import contextlib

    from pinns_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"{argv[0]} exited {rc}")
    last = buf.getvalue().strip().splitlines()[-1]
    return json.loads(last) if last.startswith("{") else {"line": last}


def phase_p2(card: str) -> dict:
    """23: the port's CLI takes its own trained model to serving on the card:
    train abgrall_admm, export --checkpoint, predict, eval --checkpoint and
    eval --artifact give the train summary's rel-L2; train --resume from a
    half-way checkpoint ends where the uninterrupted run ends, bit for bit."""
    from pinns_tpu_torch.data.datasets import load_burgers_mat
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train import checkpoint as ckpt_io
    from pinns_tpu_torch.train.evaluate import relative_l2

    preset = "abgrall_admm"
    with tempfile.TemporaryDirectory() as tmp:
        d = lambda name: os.path.join(tmp, name)  # noqa: E731
        final = lambda name: os.path.join(d(name), f"{preset}_final.ckpt")  # noqa: E731
        train = ["train", "--preset", preset, "--device", "cuda"]
        reset_counts()
        summary = cli_json(train + ["--epochs", str(P2_EPOCHS), "--out-dir", d("whole")])
        launches = kernel_counts()
        check(launches["fused_chunk_epochs"] == P2_EPOCHS and launches["fused_step"] == 0,
              f"train launches {launches}")
        cli_json(train + ["--epochs", str(P2_EPOCHS // 2), "--out-dir", d("half")])
        resumed = cli_json(train + ["--epochs", str(P2_EPOCHS), "--out-dir", d("rest"),
                                    "--resume", final("half")])
        a, b = (ckpt_io.state_to_dict(ckpt_io.load_checkpoint(final(n), "cuda"))
                for n in ("whole", "rest"))
        same = all(torch.equal(x, y) for x, y in zip(
            [t for layer in a["params"]["net"] for t in layer.values()] + [a["colloc"]],
            [t for layer in b["params"]["net"] for t in layer.values()] + [b["colloc"]]))
        check(same and a["epoch"] == b["epoch"] == P2_EPOCHS and resumed == summary,
              f"resumed run differs: {resumed} vs {summary}")
        art = d("artifact")
        cli_json(["export", "--preset", preset, "--checkpoint", final("whole"), "--out", art,
                  "--device", "cuda"])
        ds = load_burgers_mat(get_preset(preset).data.dataset)
        np.savez(d("pts.npz"), x=ds.X_star)
        cli_json(["predict", "--artifact", art, "--points", d("pts.npz"), "--out",
                  d("pred.npz"), "--device", "cuda"])
        with np.load(d("pred.npz")) as z:
            predicted = relative_l2(z["u"], ds.star["u"])
        by_ckpt = cli_json(["eval", "--preset", preset, "--checkpoint", final("whole"),
                            "--device", "cuda"])
        by_art = cli_json(["eval", "--artifact", art, "--device", "cuda"])
    rel = {"train": summary["rel_l2_u"], "predict": predicted,
           "eval_checkpoint": by_ckpt["rel_l2_u"], "eval_artifact": by_art["rel_l2_u"]}
    check(all(abs(v - rel["train"]) <= 1e-7 for v in rel.values()), f"rel-L2 differ: {rel}")
    emit(card, phase="p2", preset=preset, epochs=P2_EPOCHS, rel_l2_u=rel,
         resume_bit_equal=True, train_launches=launches["fused_chunk_epochs"],
         truth=by_art["truth"])
    return rel


def k7b_inputs(kind: str, viscous: bool, n: int):
    """K7b's inputs at n cells: centers with rows on the bounds, the edge
    values of a smooth field (rho, E > 0 for Euler) and the coefficients."""
    rng = np.random.default_rng(n + 5)
    c = rng.uniform(LB, UB, size=(n, 2)).astype(np.float32)
    c[:4] = [(LB[0], LB[1]), (UB[0], UB[1]), (LB[0], UB[1]), (UB[0], LB[1])]
    fields = 1 if kind == "burgers" else 3
    m = n * 4 * K7B_QUAD
    base = np.zeros(fields) if kind == "burgers" else np.array([1.0, 0.3, 2.5])
    y = (base + 0.3 * rng.standard_normal((m, fields))).astype(np.float32)
    yx = rng.standard_normal((m, fields)).astype(np.float32) if viscous else None
    coeffs = [0.377, 1e-3] if kind == "burgers" else [0.4, math.exp(-6.0)]
    t = lambda a: None if a is None else torch.from_numpy(a).cuda()  # noqa: E731
    g_r = rng.standard_normal((n, fields)).astype(np.float32)
    return t(c), t(y), t(yx), torch.tensor(coeffs, device="cuda"), t(g_r)


def close_or_f64(name: str, got, plain, exact) -> dict:
    """K7b against its plain version: within rtol 1e-4 / atol 1e-5 max|plain|
    (the forward repeats the plain version's operations and lands there bit
    for bit or nearly), or else the float64 criterion (compare_f64): the
    backward's formulas round in another order than autograd's, and a cell's
    difference quotient amplifies float32 rounding about 25x."""
    got, plain = np.asarray(got, np.float64), np.asarray(plain, np.float64)
    check(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    err = np.abs(got - plain)
    if bool((err <= 1e-5 * np.abs(plain).max() + 1e-4 * np.abs(plain)).all()):
        return {"max_abs_err_vs_plain": float(err.max()), "ok": True}
    return compare_f64(name, got, plain, exact)


def k7b_plain(kind: str, y, yx, hxe, hte, coeffs):
    """r from the plain quadrature (gamma - 1 is coeffs[0] for Euler)."""
    from pinns_tpu_torch.ops import weakform as twf

    if kind == "burgers":
        return twf.burgers_quadrature_reference(y, yx, hxe, hte, coeffs[0], coeffs[1], K7B_QUAD)[0]
    gamma = float(coeffs[0].detach()) + 1.0
    return torch.cat(twf.euler_quadrature_reference(y, yx, hxe, hte, gamma, coeffs[1],
                                                    K7B_QUAD)[0], dim=1)


def k7b_bytes(kind: str, viscous: bool, n: int) -> dict:
    """The bytes each K7b function must move (each input read once, each
    output written once), and its operations (per edge row: Burgers about 8
    FLOP viscous, Euler about 30; the backward about twice that)."""
    fields = 1 if kind == "burgers" else 3
    rows = n * 4 * K7B_QUAD
    vals = 4 * rows * fields * (2 if viscous else 1)
    per_row = (8 if kind == "burgers" else 30)
    return {"edge": bound([(20.0 * rows, PEAK_FP32)], 8 * n + 8 * rows + 8 * n),
            "forward": bound([(per_row * rows, PEAK_FP32)], vals + 8 * n + 8 + 4 * n * fields),
            "backward": bound([(2.0 * per_row * rows, PEAK_FP32)],
                              4 * n * fields + 2 * vals + 8 * n + 16)}


def phase_k7b(card: str) -> dict:
    """24: K7b against its plain version on the card: the edge points bit for
    bit; r and the backward (g_y, g_yx, the coefficients' gradient) by the
    float64 criterion against the plain version (autograd through it for the
    backward), viscous and inviscid, Burgers and Euler, N 1,000 and 65,536
    with centers on the bounds; two backward calls bit-equal. K7a at
    twosin_weak's shape (8x20, out 1, 16,000 points) against float64."""
    from pinns_tpu_torch.models.mlp import MLPSpec
    from pinns_tpu_torch.ops import weakform as twf
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.kernels import weakform as k7b
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1_reference

    spec = MLPSpec(layers=(2, 4, 1), lb=LB, ub=UB)
    hx, ht = 0.02 * (UB[0] - LB[0]), 0.02 * (UB[1] - LB[1])
    out = {}
    for kind, viscous, n in K7B_SHAPES:
        c, y, yx, coeffs, g_r = k7b_inputs(kind, viscous, n)
        pts, hxe, hte = k7b.edge_points(spec, c, hx, ht, K7B_QUAD)
        ppts, phxe, phte = twf.edge_points_reference(spec, c, hx, ht, K7B_QUAD)
        edge_equal = bool(torch.equal(pts, ppts) and torch.equal(hxe, phxe)
                          and torch.equal(hte, phte))
        check(edge_equal, f"K7b edge points differ from plain at {kind}, N {n}")
        r = k7b.flux_forward(kind, y, yx, hxe, hte, coeffs, K7B_QUAD)
        gy, gyx, gc = k7b.flux_backward(kind, g_r, y, yx, hxe, hte, coeffs, K7B_QUAD)
        again = k7b.flux_backward(kind, g_r, y, yx, hxe, hte, coeffs, K7B_QUAD)
        torch.cuda.synchronize()
        check(all(a is b or torch.equal(a, b) for a, b in zip((gy, gyx, gc), again)),
              f"K7b backward not repeatable at {kind}, N {n}")
        ref = {}
        for dtype in (torch.float32, torch.float64):
            args = [None if a is None else a.to(dtype).clone().requires_grad_(True)
                    for a in (y, yx, coeffs)]
            pr = k7b_plain(kind, args[0], args[1], hxe.to(dtype), hte.to(dtype), args[2])
            wrt = [a for a in args if a is not None]
            grads = torch.autograd.grad(pr, wrt, g_r.to(dtype), allow_unused=True)
            ref[dtype] = [pr] + [torch.zeros_like(a) if g is None else g
                                 for g, a in zip(grads, wrt)]
        names = ["r", "g_y"] + (["g_yx"] if viscous else []) + ["g_coeffs"]
        got = [r, gy] + ([gyx] if viscous else []) + [gc]
        rows = {name: close_or_f64(name, host(g), host(p), host(e))
                for name, g, p, e in zip(names, got, ref[torch.float32], ref[torch.float64])}
        out[(kind, viscous, n)] = (rows["r"]["max_abs_err_vs_plain"],
                                   max(v["max_abs_err_vs_plain"] for k, v in rows.items()
                                       if k != "r"))
        emit(card, phase="k7b", kind=kind, viscous=viscous, n=n, quad=K7B_QUAD,
             edge_points_bit_equal=edge_equal, backward_bit_equal=True,
             criterion="f64_oracle", outputs=rows)
    layers, n = NARROW, 16_000
    kspec, params, spec64, params64 = k7a_net(layers, 211, "cuda")
    x = points(n, seed=212, device="cuda")
    rng = np.random.default_rng(213)
    cot = [torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).cuda()
           for _ in range(3)]
    with torch.inference_mode():
        got = k_taylor1.taylor1(kspec, params, x)
        grad = k_taylor1.taylor1_backward(kspec, params, x, cot)
        plain = mlp_taylor_1_reference(kspec, params, x)
        exact = mlp_taylor_1_reference(spec64, params64, x.double())
        pgrad = k_taylor1.taylor1_backward_reference(kspec, params, x, cot)
        egrad = k_taylor1.taylor1_backward_reference(spec64, params64, x.double(),
                                                     [c.double() for c in cot])
    streams = {name: compare_f64(name, host(g), host(p), host(e))
               for name, g, p, e in zip(("y", "y_x", "y_t"), got, plain, exact)}
    off, leaves = 0, []
    for p, e in zip(pgrad, egrad):
        g = host(grad[off:off + p.numel()])
        off += p.numel()
        leaves.append(compare_f64("k7a_grad", g, host(p).ravel(), host(e).ravel()))
    emit(card, phase="k7b", what="k7a_at_twosin_weak", net="8x20", out_dim=1, n=n,
         plan=dataclasses.asdict(k_taylor1.taylor1_plan(layers, n, backward=True)),
         streams=streams, leaves=len(leaves), criterion="f64_oracle",
         backward_max_abs_err_vs_plain=max(r["max_abs_err_vs_plain"] for r in leaves))
    return out


def weak_fixture() -> dict:
    with np.load(WEAK_FIXTURE, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def weak_state(fx: dict, preset: str, device):
    """The port's TrainState at the fixture's JAX initial state of ``preset``."""
    from pinns_tpu_torch.interop import train_state_from_jax

    p = f"{preset}_"
    layers = tuple(int(w) for w in fx[p + "layers"])
    net = net_from_flat(fx[p + "params_0"], layers)
    coeffs = {"lambda1": fx[p + "coeffs_0"][0:1], "lambda2": fx[p + "coeffs_0"][1:2]}
    zeros = [{k: np.zeros_like(v) for k, v in layer.items()} for layer in net]
    zc = {k: np.zeros_like(v) for k, v in coeffs.items()}
    return train_state_from_jax({
        "params": {"net": net, "coeffs": coeffs}, "count": 0,
        "mu": {"net": zeros, "coeffs": zc}, "nu": {"net": zeros, "coeffs": zc},
        "colloc": fx[p + "colloc_0"], "epoch": 0}, device, key=int(fx[p + "seed"]))


def weak_gradient(problem, params, colloc, plain: bool, dtype=torch.float32):
    """(loss, flat net gradient in kernel order (``net_leaves``: a shock-path
    net's paths last), (dlambda1, dlambda2)) of the preset's loss."""
    from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves
    from pinns_tpu_torch.train import trainer as tr

    params = tr.tree_map(lambda t: t.to(dtype).detach().clone().requires_grad_(True), params)
    loss, _ = tr.make_loss_fn(problem, plain=plain)(params, colloc.to(dtype), None)
    leaves = net_leaves(params["net"]) + [params["coeffs"][k] for k in ("lambda1", "lambda2")]
    grads = [torch.zeros_like(p) if g is None else g for g, p in
             zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    return (float(loss.detach()), flat_np(grads[:-2]), flat_np(grads[-2:]))


def phase_weak_step(card: str) -> dict:
    """25: one step of each weak-form preset on the card from the fixture's
    JAX state at its points (loss, every gradient leaf, the coefficients'
    gradient: the identified viscosity's for euler_inverse), then the
    fixture's 3-step replay (metrics, coefficients, each leaf's sums, the
    params after the first step)."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train import trainer as tr

    fx = weak_fixture()
    out = {}
    for preset in WEAK_PRESETS:
        p = f"{preset}_"
        exp = get_preset(preset)
        problem = tr.build_problem(exp, "cuda")
        p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
        layers = tuple(int(w) for w in fx[p + "layers"])
        check(problem.spec.layers == layers and problem.spec.lb == tuple(fx[p + "lb"])
              and problem.spec.ub == tuple(fx[p + "ub"]), f"{preset}: spec")
        check(np.array_equal(host(problem.x_data), fx[p + "x_data"]),
              f"{preset}: the training set differs from JAX's")
        state = weak_state(fx, preset, problem.device)
        reset_counts()
        loss, grad, gcoeffs = weak_gradient(problem, state.params, state.colloc, plain=False)
        torch.cuda.synchronize()
        launches = kernel_counts()
        viscous_net = "taylor1" if problem.viscous_static else "mlp_forward"
        check(all(launches[k] == 1 for k in ("weakform_edge_points", "weakform_flux",
                                              "weakform_flux_backward", "mlp_backward"))
              and launches[viscous_net] == 1, f"{preset}: the loss's launches {launches}")
        _, g64, gc64 = weak_gradient(p64, state.params, state.colloc, plain=True,
                                     dtype=torch.float64)
        rows = {"loss": close("loss", loss, fx[p + "loss_0"], scale=abs(float(fx[p + "loss_0"]))),
                "grad_0": close_grad(grad, fx[p + "grad_0"], layers, g64)}
        row = measure("grad", gcoeffs, fx[p + "gcoeffs_0"])
        if not row["ok"]:
            row = dict(compare_f64("gcoeffs", gcoeffs, fx[p + "gcoeffs_0"], gc64),
                       max_abs_err=float(np.abs(gcoeffs - fx[p + "gcoeffs_0"]).max()))
        rows["gcoeffs_0"] = row
        lr = tr.learning_rate_schedule(exp.optimizer)
        step = tr.make_step(problem, lr)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(problem.device)  # noqa: E731
        replay, k = [], 1
        while f"{p}metrics_{k}" in fx:
            state, m = step(state, new_colloc=t(fx[f"{p}colloc_{k}"]))
            m = {n: float(v) for n, v in m.items()}
            want = dict(zip(tr.METRIC_KEYS, fx[f"{p}metrics_{k}"].tolist()))
            r = {n: close("loss", m[n], want[n], scale=abs(want["loss"]))
                 for n in ("loss", "data_term", "res_term", "lambda1", "lambda2")}
            got = [host(v).astype(np.float64) for layer in state.params["net"]
                   for v in layer.values()]
            r["leaf_sums"] = close("leaf_sums", np.asarray([(v.sum(), (v * v).sum())
                                                            for v in got]), fx[f"{p}sums_{k}"])
            coeffs = np.asarray([float(state.params["coeffs"][c][0])
                                 for c in ("lambda1", "lambda2")])
            r["coeffs"] = close("adam", coeffs, fx[f"{p}coeffs_{k}"])
            if k == 1:
                r["params"] = close_adam_params(flat_np(tr.tree_leaves(state.params["net"])),
                                                fx[p + "params_1"], exp.optimizer.learning_rate)
            replay.append(r)
            k += 1
        out[preset] = rows["grad_0"]["max_abs_err"]
        emit(card, phase="weak-step", preset=preset, seed=int(fx[p + "seed"]), step_0=rows,
             launches=launches, replay_steps=len(replay), per_step=replay)
    return out


def reduced_weak(preset: str, epochs: int, seed: int, out_dir: str = None):
    """``preset`` through Trainer.train on the card for ``epochs`` epochs of
    its cosine schedule (uncut): (trainer, summary, logs, launches, wall
    seconds); the counts are set to 0 just before train and read just after,
    and every epoch must have gone through K7b, K7a (or K5) and K5 (K7a
    twice under the mixed formulation: the edge points and the centres).
    The metrics and the final checkpoint go to ``out_dir`` when given."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.train import trainer as tr

    with tempfile.TemporaryDirectory() as tmp:
        tmp = out_dir or tmp
        exp = override(get_preset(preset), {"train.epochs": epochs, "train.seed": seed,
                                            "train.log_every": 1000, "train.out_dir": tmp})
        trainer = tr.Trainer(exp, device="cuda")
        state = trainer.init_state()
        reset_counts()
        with PlainCalls() as plain:
            t0 = time.perf_counter()
            state, summary = trainer.train(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernel_counts()
        with open(os.path.join(tmp, f"{preset}_metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f if "summary" not in line]
    check(plain.calls == 0, f"{plain.calls} calls of plain versions on the path")
    euler = exp.pde.kind == "euler"
    # every epoch in a replay of K9's generic graph; each capture's warm-up
    # epoch runs the kernels too
    n = epochs + launches["generic_chunk_captures"]
    k7a = n * (1 + int(bool(exp.loss.strong_equations)))
    # an epoch: K7b's three calls, K7a forward and backward at the edge
    # points (and at the centres, mixed), K5 forward and backward on the
    # data term; the evaluation one K7a (Euler) or K1 (Burgers) forward over
    # the grid
    # the edge points' K7a on its narrow design at twosin_weak's 8x20, on
    # the wide one at the Euler trunk
    want = {"weakform_edge_points": n, "weakform_flux": n,
            "weakform_flux_backward": n, "taylor1": k7a + int(euler),
            "taylor1_backward": k7a, "taylor1_narrow": 0 if euler else k7a,
            "taylor1_narrow_backward": 0 if euler else k7a, "mlp_forward": n,
            "mlp_backward": n, "taylor2": int(not euler), "taylor2_backward": 0,
            "philox_draw": n, "generic_chunk_epochs": epochs,
            "fused_step": 0, "fused_chunk_epochs": 0}
    check(all(launches[k] == v for k, v in want.items()), f"launches {launches}, want {want}")
    fields = EULER_FIELDS if euler else ("u",)
    # (the causal weights rise as the early bins are fit, so the loss need
    # not fall between logs; the band of phase 26 holds the quality)
    check(all(math.isfinite(v) for r in logs for v in r.values() if isinstance(v, float))
          and all(math.isfinite(summary[f"rel_l2_{f}"]) for f in fields), "non-finite metrics")
    return trainer, summary, logs, launches, wall


def phase_weak_train(card: str) -> dict:
    """26: twosin_weak at the fixture's reduced schedule (3,000 epochs of the
    preset's cosine schedule, uncut) for JAX's three band seeds, the median
    u rel-L2 in the band of JAX's three; euler_inverse once for
    UNHELD_EPOCHS (printed, not held)."""
    fx = weak_fixture()
    epochs, seeds = int(fx["band_epochs"]), fx["band_seeds"].tolist()
    band = (float(fx["band_rel_l2"].min()) - WEAK_MARGIN,
            float(fx["band_rel_l2"].max()) + WEAK_MARGIN)
    runs = []
    for seed in seeds:
        trainer, summary, logs, launches, wall = reduced_weak("twosin_weak", epochs, seed)
        runs.append({"seed": seed, "rel_l2_u": summary["rel_l2_u"], "truth": summary["truth"],
                     "wall_s": wall, "loss": [logs[0]["loss"], logs[-1]["loss"]],
                     "launches": launches})
        if seed == seeds[0]:
            first = {"twosin_weak": trainer, "launches": launches, "wall_s": wall}
    median = statistics.median(r["rel_l2_u"] for r in runs)
    check(band[0] <= median <= band[1], f"median u rel-L2 {median} outside the JAX band {band}")
    trainer, inv, logs, inv_launches, inv_wall = reduced_weak("euler_inverse", UNHELD_EPOCHS,
                                                              seeds[0])
    first.update(euler_inverse=trainer, euler_launches=inv_launches)
    emit(card, phase="weak-train", preset="twosin_weak", epochs=epochs, runs=runs,
         median_rel_l2_u=median, band=list(band),
         jax_seeds=dict(zip(map(str, seeds), fx["band_rel_l2"].tolist())),
         euler_inverse={"seed": seeds[0], "epochs": UNHELD_EPOCHS,
                        **{f: inv[f"rel_l2_{f}"] for f in EULER_FIELDS},
                        "nu": inv["lambda2"], "wall_s": inv_wall, "launches": inv_launches,
                        "loss": [logs[0]["loss"], logs[-1]["loss"]], "held": False})
    return first


def phase_weak_times(card: str, train: dict) -> dict:
    """times: K7b's three functions against their plain versions (CUDA
    events; the backward against autograd through the plain forward) at
    N 1,000 and 65,536; each preset's epoch by events against the plain step,
    and a 1,000-epoch chunk."""
    from pinns_tpu_torch.models.mlp import MLPSpec
    from pinns_tpu_torch.ops import weakform as twf
    from pinns_tpu_torch.ops.kernels import weakform as k7b
    from pinns_tpu_torch.train import trainer as tr

    spec = MLPSpec(layers=(2, 4, 1), lb=LB, ub=UB)
    hx, ht = 0.02 * (UB[0] - LB[0]), 0.02 * (UB[1] - LB[1])
    out = {}
    for kind, viscous, n in K7B_TIMES:
        c, y, yx, coeffs, g_r = k7b_inputs(kind, viscous, n)
        _, hxe, hte = k7b.edge_points(spec, c, hx, ht, K7B_QUAD)
        args = [None if a is None else a.clone().requires_grad_(True) for a in (y, yx, coeffs)]
        wrt = [a for a in args if a is not None]
        with torch.no_grad():
            edge = event_ms(lambda: k7b.edge_points(spec, c, hx, ht, K7B_QUAD))
            edge_plain = event_ms(lambda: twf.edge_points_reference(spec, c, hx, ht, K7B_QUAD))
            fwd = event_ms(lambda: k7b.flux_forward(kind, y, yx, hxe, hte, coeffs, K7B_QUAD))
            fwd_plain = event_ms(lambda: k7b_plain(kind, y, yx, hxe, hte, coeffs))
            bwd = event_ms(lambda: k7b.flux_backward(kind, g_r, y, yx, hxe, hte, coeffs,
                                                     K7B_QUAD))
        bwd_plain = event_ms(lambda: torch.autograd.grad(
            k7b_plain(kind, args[0], args[1], hxe, hte, args[2]), wrt, g_r, allow_unused=True))
        b = k7b_bytes(kind, viscous, n)
        out[(kind, viscous, n)] = {"edge": (edge, edge_plain, b["edge"]),
                                   "forward": (fwd, fwd_plain, b["forward"]),
                                   "backward": (bwd, bwd_plain, b["backward"])}
        emit(card, phase="times", what="k7b", kind=kind, viscous=viscous, n=n,
             edge_ms=edge, edge_plain_ms=edge_plain, edge_bound_ms=b["edge"][0],
             forward_ms=fwd, forward_plain_ms=fwd_plain, forward_bound_ms=b["forward"][0],
             backward_ms=bwd, backward_plain_ms=bwd_plain, backward_bound_ms=b["backward"][0],
             reps=REPS, clock="cuda_events",
             plain="ops.weakform plain versions; backward by autograd through the forward")
    for preset in WEAK_PRESETS:
        trainer = train[preset]
        state = trainer.init_state(seed=3)
        step = trainer._adam_step
        plain_step = tr.make_adam_step(trainer.problem, trainer.learning_rate, plain=True)
        ms = event_ms(lambda: step(state))
        plain_ms = event_ms(lambda: plain_step(state))
        tr.run_chunk(step, state, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_chunk(step, state, 1000)
        torch.cuda.synchronize()
        chunk = time.perf_counter() - t0
        out[preset] = (ms, plain_ms, 1000 / chunk)
        emit(card, phase="times", what="weak_epoch", preset=preset, epoch_ms=ms,
             plain_ms=plain_ms, reps=REPS, clock="cuda_events", chunk_epochs=1000,
             chunk_wall_s=chunk, epochs_per_s=1000 / chunk)
    return out


# -- 27-29 and times: the shock-path slice (paths in K7a and K5) ---------------

def path_net(layers, seed: int, device):
    """A seeded net with two shock paths (degree 2, sharpness 12) moved off
    their init, nonzero biases, and its float64 twin."""
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp

    spec = MLPSpec(layers=layers, lb=LB, ub=UB, n_paths=2, path_degree=2, path_sharpness=12.0)
    params = init_mlp(spec, torch.Generator().manual_seed(seed), device)
    gen = torch.Generator().manual_seed(seed + 1)
    for p in params:
        p["b"].copy_(0.1 * torch.randn(p["b"].shape, generator=gen))
    params[0]["path_c"].add_(0.3 * torch.randn((2, 3), generator=gen).to(device))
    params[0]["path_a"].mul_(1.0 + 0.2 * torch.randn(2, generator=gen).to(device))
    return spec, params, dataclasses.replace(spec, dtype=torch.float64), net_f64(params)


def path_ops(spec, n: int, streams: int):
    """The paths' own work in an input pass: about 20 FLOP a path and point
    for the value stream, 10 more for each tangent stream."""
    return [((10.0 + 10.0 * streams) * spec.n_paths * n, PEAK_FP32)]


def path_bounds(spec, n: int) -> dict:
    """The bounds of K7a's and K5's forward and backward with paths: the
    trunk's products at the embedded widths, the paths' own work, and the
    backward's gH of layer 0 (the adjoints of the path features)."""
    w = spec.widths
    m = _macs(w)
    nb_fwd7 = 8 * n + 12 * n * w[-1] + 4 * spec.n_params
    nb_fwd5 = 8 * n + 4 * n * w[-1] + 4 * spec.n_params
    bwd7 = taylor1_ops(w, n) + [(3 * 2.0 * (2 * sum(m)) * n, PEAK_FP32)]
    bwd5 = [(3 * 2.0 * sum(m) * n, PEAK_FP32)]
    return {"k7a": bound(taylor1_ops(w, n) + path_ops(spec, n, 3), nb_fwd7),
            "k7a_backward": bound(bwd7 + path_ops(spec, n, 3) * 3,
                                  nb_fwd7 + 4 * spec.n_params),
            "k5": bound([(2.0 * sum(m) * n, PEAK_FP32)] + path_ops(spec, n, 1), nb_fwd5),
            "k5_backward": bound(bwd5 + path_ops(spec, n, 1) * 3, nb_fwd5 + 4 * spec.n_params)}


def path_kernel_fns(kernel: str):
    """(forward, backward) of K7a (three streams) or K5 (one):
    forward(spec, params, x) -> outputs, backward(spec, params, x, cot) ->
    the flat gradient."""
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1

    if kernel == "k7a":
        return k_taylor1.taylor1, k_taylor1.taylor1_backward
    return (lambda s, p, x: (k_mlp.mlp_forward(s, p, x),),
            lambda s, p, x, cot: k_mlp.mlp_backward(s, p, x, cot[0]))


def path_kernel_call(kernel: str, spec, params, x, cot):
    """(outputs, flat gradient) of K7a or K5 with the cotangents ``cot``."""
    fwd, bwd = path_kernel_fns(kernel)
    return fwd(spec, params, x), bwd(spec, params, x, cot)


def path_plain_call(kernel: str, spec, params, x, cot):
    """The plain versions of ``path_kernel_call``: the forward reference and
    the backward algorithm in PyTorch (a list of leaves)."""
    from pinns_tpu_torch.models.mlp import mlp_apply_reference
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1_reference

    if kernel == "k7a":
        return (mlp_taylor_1_reference(spec, params, x),
                k_taylor1.taylor1_backward_reference(spec, params, x, cot))
    return ((mlp_apply_reference(spec, params, x),),
            k_mlp.mlp_backward_reference(spec, params, x, cot[0]))


def phase_paths(card: str) -> dict:
    """27: K7a and K5 (wide) with two shock paths on the Euler trunk against
    float64 (compare_f64), every stream and every gradient leaf, path_c and
    path_a included; two backward calls agree bit for bit."""
    out = {}
    for n in PATH_NS:
        spec, params, spec64, params64 = path_net(EULER, 214, "cuda")
        x = points(n, seed=n + 11, device="cuda")
        for kernel, streams in (("k7a", 3), ("k5", 1)):
            rng = np.random.default_rng(n + 12)
            cot = [torch.from_numpy(rng.standard_normal((n, EULER[-1])).astype(np.float32))
                   .cuda() for _ in range(streams)]
            with torch.inference_mode():
                got, grad = path_kernel_call(kernel, spec, params, x, cot)
                _, again = path_kernel_call(kernel, spec, params, x, cot)
                plain, pgrad = path_plain_call(kernel, spec, params, x, cot)
                exact, egrad = path_plain_call(kernel, spec64, params64, x.double(),
                                               [c.double() for c in cot])
            torch.cuda.synchronize()
            check(torch.equal(grad, again), f"{kernel} backward with paths not repeatable, N {n}")
            check(grad.numel() == spec.n_params, f"{kernel}: {grad.numel()} gradient entries")
            rows = {f"out{i}": compare_f64(f"{kernel} out{i}", host(g), host(p), host(e))
                    for i, (g, p, e) in enumerate(zip(got, plain, exact))}
            leaves, off = [], 0
            for p, e in zip(pgrad, egrad):
                g = host(grad[off:off + p.numel()])
                off += p.numel()
                leaves.append(dict(compare_f64(f"{kernel} grad", g, host(p).ravel(),
                                               host(e).ravel()),
                                   max_abs_err=float(np.abs(g - host(p).ravel()).max())))
            fwd_err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
            bwd_err = max(r["max_abs_err"] for r in leaves)
            out[(kernel, n)] = (fwd_err, bwd_err)
            emit(card, phase="k7a/k5-paths", kernel=kernel, net="2x200x5x3", n_paths=2, n=n,
                 criterion="f64_oracle", outputs=rows, forward_max_abs_err=fwd_err,
                 backward_max_abs_err=bwd_err, path_c=leaves[-2], path_a=leaves[-1],
                 leaves=len(leaves), bit_equal=True)
    return out


def path_fixture() -> dict:
    with np.load(PATH_FIXTURE, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def path_fixture_net(fx: dict, flat: np.ndarray, spec) -> list:
    """A flat fixture vector (W_0, b_0, ..., path_c, path_a) as JAX-layout
    numpy params of ``spec``."""
    sizes = [a for din, dout in zip(spec.widths[:-1], spec.widths[1:])
             for a in (din * dout, dout)] + [spec.n_paths * (spec.path_degree + 1), spec.n_paths]
    leaves = np.split(flat, np.cumsum(sizes)[:-1])
    net = [{"W": w.reshape(din, dout), "b": b.reshape(1, dout)}
           for w, b, din, dout in zip(leaves[0:-2:2], leaves[1:-2:2], spec.widths[:-1],
                                      spec.widths[1:])]
    net[0]["path_c"] = leaves[-2].reshape(spec.n_paths, spec.path_degree + 1)
    net[0]["path_a"] = leaves[-1]
    return net, sizes


def phase_path_step(card: str) -> dict:
    """28: one euler_weak_fast step on the card from the fixture's JAX state
    (loss, every gradient leaf with the paths', the launches of one loss),
    then the fixture's 3-step replay (metrics, coefficients, each leaf's
    sums, the params after the first step)."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.interop import train_state_from_jax
    from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves
    from pinns_tpu_torch.train import trainer as tr

    fx = path_fixture()
    exp = get_preset(PATH_PRESET)
    problem = tr.build_problem(exp, "cuda")
    p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
    spec = problem.spec
    check(spec.layers == tuple(int(w) for w in fx["layers"]) and spec.lb == tuple(fx["lb"])
          and spec.ub == tuple(fx["ub"]) and spec.n_paths == int(fx["n_paths"])
          and spec.path_degree == int(fx["path_degree"]), f"{PATH_PRESET}: spec")
    check(np.array_equal(host(problem.x_data), fx["x_data"]), "the training set differs")
    net, sizes = path_fixture_net(fx, fx["params_0"], spec)
    coeffs = {"lambda1": fx["coeffs_0"][0:1], "lambda2": fx["coeffs_0"][1:2]}
    zeros = [{k: np.zeros_like(v) for k, v in layer.items()} for layer in net]
    zc = {k: np.zeros_like(v) for k, v in coeffs.items()}
    state = train_state_from_jax({
        "params": {"net": net, "coeffs": coeffs}, "count": 0,
        "mu": {"net": zeros, "coeffs": zc}, "nu": {"net": zeros, "coeffs": zc},
        "colloc": fx["colloc_0"], "epoch": 0}, problem.device, key=int(fx["seed"]))
    reset_counts()
    loss, grad, gcoeffs = weak_gradient(problem, state.params, state.colloc, plain=False)
    torch.cuda.synchronize()
    launches = kernel_counts()
    check(all(launches[k] == 1 for k in ("weakform_edge_points", "weakform_flux",
                                          "weakform_flux_backward", "mlp_forward", "mlp_backward"))
          and launches["taylor1"] == 2 and launches["taylor1_backward"] == 2,
          f"the loss's launches {launches}")
    _, g64, _ = weak_gradient(p64, state.params, state.colloc, plain=True, dtype=torch.float64)
    rows = {"loss": close("loss", loss, fx["loss_0"], scale=abs(float(fx["loss_0"]))),
            "grad_0": close_grad(grad, fx["grad_0"], None, g64, sizes=sizes),
            "gcoeffs_0": close("grad", gcoeffs, fx["gcoeffs_0"], scale=1.0)}
    step = tr.make_step(problem, tr.learning_rate_schedule(exp.optimizer))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(problem.device)  # noqa: E731
    replay, k = [], 1
    while f"metrics_{k}" in fx:
        state, m = step(state, new_colloc=t(fx[f"colloc_{k}"]))
        m = {n: float(v) for n, v in m.items()}
        want = dict(zip(tr.METRIC_KEYS, fx[f"metrics_{k}"].tolist()))
        r = {n: close("loss", m[n], want[n], scale=abs(want["loss"]))
             for n in ("loss", "data_term", "res_term", "lambda1", "lambda2")}
        got = [host(v).astype(np.float64) for v in net_leaves(state.params["net"])]
        r["leaf_sums"] = close("leaf_sums", np.asarray([(v.sum(), (v * v).sum()) for v in got]),
                               fx[f"sums_{k}"])
        r["coeffs"] = close("adam", np.asarray([float(state.params["coeffs"][c][0])
                                                for c in ("lambda1", "lambda2")]),
                            fx[f"coeffs_{k}"])
        if k == 1:
            r["params"] = close_adam_params(flat_np(net_leaves(state.params["net"])),
                                            fx["params_1"], exp.optimizer.learning_rate)
        replay.append(r)
        k += 1
    emit(card, phase="weak-paths-step", preset=PATH_PRESET, seed=int(fx["seed"]), step_0=rows,
         launches=launches, replay_steps=len(replay), per_step=replay)
    return {"grad_err": rows["grad_0"]["max_abs_err"]}


def phase_path_train(card: str) -> dict:
    """29: euler_weak_fast at the fixture's reduced schedule for JAX's three
    band seeds (the median of each field within JAX's three +- PATH_MARGIN);
    the first seed's checkpoint exported and graded through the CLI; the
    fixture's JAX-trained net served on the card against JAX's outputs."""
    from pinns_tpu_torch.serve import ServedModel, export_predict, make_http_server

    fx = path_fixture()
    epochs, seeds = int(fx["band_epochs"]), fx["band_seeds"].tolist()
    band = {f: (float(fx["band_rel_l2"][:, i].min()) - PATH_MARGIN,
                float(fx["band_rel_l2"][:, i].max()) + PATH_MARGIN)
            for i, f in enumerate(EULER_FIELDS)}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            trainer, summary, logs, launches, wall = reduced_weak(
                PATH_PRESET, epochs, seed, out_dir=tmp if seed == seeds[0] else None)
            runs.append({"seed": seed, **{f: summary[f"rel_l2_{f}"] for f in EULER_FIELDS},
                         "wall_s": wall, "loss": [logs[0]["loss"], logs[-1]["loss"]],
                         "launches": launches})
            if seed == seeds[0]:
                first = {"trainer": trainer, "launches": launches, "wall_s": wall,
                         "summary": summary}
        medians = {f: statistics.median(r[f] for r in runs) for f in EULER_FIELDS}
        check(all(band[f][0] <= medians[f] <= band[f][1] for f in EULER_FIELDS),
              f"median rel-L2 {medians} outside the JAX band {band}")
        # the port's own checkpoint, through the CLI
        ckpt = os.path.join(tmp, f"{PATH_PRESET}_final.ckpt")
        art = os.path.join(tmp, "artifact")
        cli_json(["export", "--preset", PATH_PRESET, "--checkpoint", ckpt, "--out", art,
                  "--device", "cuda"])
        graded = cli_json(["eval", "--artifact", art, "--device", "cuda"])
        check(all(abs(graded[f"rel_l2_{f}"] - first["summary"][f"rel_l2_{f}"]) <= 1e-6
                  for f in EULER_FIELDS), f"eval --artifact {graded} vs train {first['summary']}")
        # the fixture's JAX-trained path net, served
        spec = first["trainer"].problem.spec
        net, _ = path_fixture_net(fx, fx["band_params"], spec)
        jart = export_predict(spec, net, os.path.join(tmp, "jax"), 1.0, 1e-3,
                              experiment=PATH_PRESET, pde="euler", gamma=float(fx["gamma"]))
        served = ServedModel(jart, device="cuda")
        check(served.spec == spec, "the served spec")
        x = fx["predict_x"]
        reset_counts()
        out = served.predict(x, pad_to_bucket=True)
        served_launches = kernel_counts()
        check(served_launches["taylor1"] == 1 and served_launches["mlp_forward"] == 0,
              f"served launches {served_launches}")
        vs_jax = {}
        for k in EULER_OUT:
            got, want = out[k].ravel().astype(np.float64), fx[f"predict_{k}"].astype(np.float64)
            err = np.abs(got - want)
            atol = 1e-5 * float(np.abs(want).max())
            check(bool((err <= atol + 1e-5 * np.abs(want)).all()),
                  f"served {k}: max err {err.max()} (atol {atol})")
            vs_jax[k] = {"max_abs_err": float(err.max()), "atol": atol, "rtol": 1e-5}
        server = make_http_server(jart, port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://127.0.0.1:%d" % server.server_address[1]
            code, _, body = http(base + "/predict", json.dumps({"x": x[:8].tolist()}).encode())
            want8 = served.predict(x[:8], pad_to_bucket=True)
            got8 = {k: np.asarray(v, np.float32) for k, v in json.loads(body).items()}
            check(code == 200 and all(np.array_equal(got8[k], want8[k]) for k in want8),
                  f"HTTP predict answered {code}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "HTTP server thread did not stop")
    emit(card, phase="euler_weak_fast", epochs=epochs, runs=runs, median_rel_l2=medians,
         band=band, jax_seeds={str(s): dict(zip(EULER_FIELDS, r)) for s, r in
                               zip(seeds, fx["band_rel_l2"].tolist())},
         cli_eval_artifact=graded, served_vs_jax=vs_jax, served_launches=served_launches,
         served_points=int(x.shape[0]), http_points=8)
    return first


def path_entry(train: dict, counter: str, errs: dict, times: dict, kernel: str, n: int,
               which: int) -> dict:
    """A path variant's keys in the kernels line: its launches in phase 29's
    first seed, its error (phase 27) and times (``phase_path_times``) at N
    ``n``, forward (which 0) or backward (1)."""
    t = times[(kernel, n)]["forward" if which == 0 else "backward"]
    return {"launches": train["launches"][counter], "max_abs_err": errs[(kernel, n)][which],
            "ms": t[0], "plain_ms": t[1], **bound_fields(t[2])}


def phase_path_times(card: str, train: dict) -> dict:
    """times: K7a and K5 with and without paths (events) beside their bounds
    and their plain versions (the backward by autograd through the plain
    forward); the euler_weak_fast epoch against the plain step (events), and
    a 1,000-epoch chunk."""
    from pinns_tpu_torch.ops.kernels.taylor2 import net_from_leaves, net_leaves
    from pinns_tpu_torch.train import trainer as tr

    out = {}
    shapes = [("k7a", n) for n in PATH_K7A_TIMES] + [("k5", PATH_K5_MAIN)]
    for kernel, n in shapes:
        streams = 3 if kernel == "k7a" else 1
        x = points(n, seed=n + 13, device="cuda")
        cot = [torch.ones((n, EULER[-1]), device="cuda") for _ in range(streams)]
        row = {}
        kfwd, kbwd = path_kernel_fns(kernel)
        for tag, (spec, params, _, _) in (("paths", path_net(EULER, 214, "cuda")),
                                          ("no_paths", k7a_net(EULER, 214, "cuda"))):
            with torch.no_grad():
                row[tag] = (event_ms(lambda: kfwd(spec, params, x)),
                            event_ms(lambda: kbwd(spec, params, x, cot)))
        spec, params, _, _ = path_net(EULER, 214, "cuda")
        leaves = [t.detach().clone().requires_grad_(True) for t in net_leaves(params)]
        net = net_from_leaves(leaves, spec.n_paths)
        with torch.no_grad():
            fwd_plain = event_ms(lambda: path_plain_call(kernel, spec, params, x, cot)[0])
        ref = "mlp_taylor_1_reference" if kernel == "k7a" else "mlp_apply_reference"

        def plain_backward():
            outs = path_plain_call(kernel, spec, net, x, cot)[0]
            return torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(outs, cot)), leaves)

        bwd_plain = event_ms(plain_backward)
        b = path_bounds(spec, n)
        fwd, bwd = row["paths"]
        out[(kernel, n)] = {"forward": (fwd, fwd_plain, b[kernel]),
                            "backward": (bwd, bwd_plain, b[f"{kernel}_backward"]),
                            "no_paths": row["no_paths"]}
        emit(card, phase="times", what=f"{kernel}_paths", net="2x200x5x3", n_paths=2, n=n,
             forward_ms=fwd, backward_ms=bwd, no_paths_forward_ms=row["no_paths"][0],
             no_paths_backward_ms=row["no_paths"][1],
             path_share_forward=1.0 - row["no_paths"][0] / fwd,
             path_share_backward=1.0 - row["no_paths"][1] / bwd,
             forward_plain_ms=fwd_plain, backward_plain_ms=bwd_plain,
             forward_bound_ms=b[kernel][0], backward_bound_ms=b[f"{kernel}_backward"][0],
             reps=REPS, clock="cuda_events", plain=f"{ref}; backward by autograd through it")
    trainer = train["trainer"]
    state = trainer.init_state(seed=3)
    step = trainer._adam_step
    plain_step = tr.make_adam_step(trainer.problem, trainer.learning_rate, plain=True)
    ms = event_ms(lambda: step(state))
    plain_ms = event_ms(lambda: plain_step(state))
    tr.run_chunk(step, state, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run_chunk(step, state, 1000)
    torch.cuda.synchronize()
    chunk = time.perf_counter() - t0
    out["epoch"] = (ms, plain_ms, 1000 / chunk)
    emit(card, phase="times", what="weak_epoch", preset=PATH_PRESET, epoch_ms=ms,
         plain_ms=plain_ms, reps=REPS, clock="cuda_events", chunk_epochs=1000,
         chunk_wall_s=chunk, epochs_per_s=1000 / chunk)
    return out


# -- 30-32: ensembles (slice 4a, K8) -------------------------------------------
K8_MEMBERS = (1, 3, 8, 32)  # phase 30's member counts
K8_EPOCHS = 5  # chained epochs of phase 30
K8_TIMES = (1, 8, 32)  # phase 32's member counts
K8_MAIN = 8  # the member count of the kernels line's K8 entry
ENS_CLI = {"members": 4, "epochs": 510, "switch": 500, "lbfgs_iters": 20, "sweep_epochs": 300}
K8_OUTPUTS = ("params", "mu", "nu", "colloc", "z", "dual", "metrics", "grad")


def k8_call(problem, lr: float, bufs: dict, count: int, epoch: int, table):
    """One K8 call on stacked buffers {params, mu, nu (E, P), colloc, z, dual}."""
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused

    exp = problem.exp
    return k_fused.fused_adam_ensemble_step(
        problem.spec, bufs["params"], bufs["mu"], bufs["nu"], count, problem.x_data,
        problem.targets["u"].contiguous(), bufs["colloc"], bufs["z"], bufs["dual"], table,
        kind=exp.loss.residual_kind, lam1=exp.pde.lambda1, lam2=exp.pde.lambda2, lr=lr,
        explicit_inner=exp.loss.explicit_inner, epoch=epoch, want_grad=True)


def k3_call(problem, lr: float, bufs: dict, count: int, epoch: int, seed: int, rho: float):
    """One solo K3 call on a member's buffers."""
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused

    exp = problem.exp
    return k_fused.fused_adam_step(
        problem.spec, bufs["params"], bufs["mu"], bufs["nu"], count, problem.x_data,
        problem.targets["u"].contiguous(), bufs["colloc"], bufs["z"], bufs["dual"],
        kind=exp.loss.residual_kind, lam1=exp.pde.lambda1, lam2=exp.pde.lambda2, rho=rho, lr=lr,
        explicit_inner=exp.loss.explicit_inner, seed=seed, epoch=epoch, want_grad=True)


def k8_members(n: int):
    """Phase 30's members: seeds 1234 + i, rhos 10, 20, 30, ..."""
    return [1234 + i for i in range(n)], [10.0 * (i + 1) for i in range(n)]


def stacked_bufs(stacked, n_params: int) -> dict:
    from pinns_tpu_torch.ops.kernels.fused_step import flat_net

    opt = stacked.opt_state
    return {"params": flat_net(stacked.params["net"], n_params),
            "mu": flat_net(opt.mu["net"], n_params), "nu": flat_net(opt.nu["net"], n_params),
            "colloc": stacked.colloc, "z": stacked.admm.z, "dual": stacked.admm.dual}


def phase_k8(card: str) -> dict:
    """30: K8 against solo K3 at abgrall_admm's 8x20 for E = 1, 3, 8 and 32 with
    distinct rhos and seeds: every output of every member equal to a solo K3
    call bit for bit over K8_EPOCHS chained epochs; the first epoch of each
    member within STEP_TOL of the plain step at its rho (hold_narrow_step)."""
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.parallel import ensemble as ens
    from pinns_tpu_torch.train import trainer as tr

    trainer = tr.Trainer(get_preset("abgrall_admm"), device="cuda")
    problem, lr = trainer.problem, trainer.learning_rate
    n_params, n_f = problem.spec.n_params, problem.exp.sampling.n_f
    out = {"grad_err": 0.0}
    for n in K8_MEMBERS:
        seeds, rhos = k8_members(n)
        stacked = ens.init_ensemble_states(trainer, seeds, rhos)
        first = ens.unstack_states(stacked)
        table = k_fused.member_table(seeds, rhos, n_f, problem.device)
        cur = stacked_bufs(stacked, n_params)
        solo = [{k: v[m].clone() for k, v in cur.items()} for m in range(n)]
        before = (k_fused.ENSEMBLE_LAUNCHES, k_fused.LAUNCHES)
        rows = {}
        per_epoch_metrics = []
        for t in range(K8_EPOCHS):
            r8 = k8_call(problem, lr, cur, t, t + 1, table)
            per_epoch_metrics.append(r8["metrics"])
            rs = [k3_call(problem, lr, solo[m], t, t + 1, seeds[m], rhos[m]) for m in range(n)]
            torch.cuda.synchronize()
            for m in range(n):
                for k in K8_OUTPUTS:
                    check(torch.equal(r8[k][m], rs[m][k]),
                          f"K8 at E={n}, epoch {t + 1}: member {m}'s {k} differs from solo K3")
            if t == 0:
                for m in range(n):
                    rows[f"m{m}"] = hold_narrow_step(problem, lr, first[m],
                                                     {k: r8[k][m] for k in K8_OUTPUTS})
                    out["grad_err"] = max(out["grad_err"], rows[f"m{m}"]["grad"]["max_abs_err"])
            cur = {k: r8[k] for k in ("params", "mu", "nu", "colloc", "z", "dual")}
            solo = [{k: rs[m][k] for k in cur} for m in range(n)]
        k8_calls = k_fused.ENSEMBLE_LAUNCHES - before[0]
        check(k8_calls == K8_EPOCHS and k_fused.LAUNCHES - before[1] == n * K8_EPOCHS,
              f"E={n}: {k8_calls} K8 calls for {K8_EPOCHS} epochs")
        # the same epochs as one graphed chunk (K9 over K8), bit for bit
        graphed, gm = ens.make_ensemble_chunk(trainer, K8_EPOCHS)(stacked)
        check(all(torch.equal(v, cur[k])
                  for k, v in stacked_bufs(graphed, n_params).items())
              and torch.equal(torch.stack([gm[k] for k in tr.METRIC_KEYS], -1),
                              torch.stack(per_epoch_metrics)),
              f"E={n}: the graphed K8 chunk differs from the chained K8 calls")
        emit(card, phase="k8", preset="abgrall_admm", net="8x20", members=n, seeds=seeds,
             rhos=rhos, epochs=K8_EPOCHS, bit_equal_to_solo_k3=True,
             criterion="torch.equal vs solo K3 on every output; STEP_TOL vs the plain step "
                       "at the member's rho (epoch 1)",
             rows={m: {k: v["max_abs_err"] for k, v in r.items()} for m, r in rows.items()},
             k8_host_calls=k8_calls, graphed_chunk_bit_equal=True)
    # the wrapper refuses a member table of another member count
    stacked = ens.init_ensemble_states(trainer, *k8_members(3))
    bad = k_fused.member_table(*k8_members(2), n_f, problem.device)
    try:
        k8_call(problem, lr, stacked_bufs(stacked, n_params), 0, 1, bad)
        check(False, "K8 took a member table of the wrong length")
    except ValueError:
        pass
    return out


def cli_lines(argv) -> list:
    """``python -m pinns_tpu_torch <argv>`` in this process: its exit code
    and the JSON objects of its output lines."""
    import contextlib

    from pinns_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]


def same_state(a_path: str, b_path: str) -> bool:
    """Two checkpoints hold equal tensors (params, Adam moments, z, dual, batch)."""
    from pinns_tpu_torch.opt.adam import tree_leaves
    from pinns_tpu_torch.train import checkpoint as ckpt_io

    a, b = (ckpt_io.state_to_dict(ckpt_io.load_checkpoint(p, "cuda")) for p in (a_path, b_path))
    # a run without ADMM keeps None there
    ta = tree_leaves([a["params"], a["adam"]["mu"], a["adam"]["nu"], a["admm"] or [], a["colloc"]])
    tb = tree_leaves([b["params"], b["adam"]["mu"], b["adam"]["nu"], b["admm"] or [], b["colloc"]])
    return (a["epoch"] == b["epoch"] and a["adam"]["count"] == b["adam"]["count"]
            and len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb)))


def phase_ensemble_cli(card: str, keep: str) -> dict:
    """31: the CLI on the card, slice 4a's main path: train --ensemble 4
    over the hybrid switch (Adam through K8, then each member's L-BFGS outer
    epochs on K5/K1/K2) with --select; each member's final checkpoint equal
    to its solo run's bit for bit, and --resume from the epoch-500 set ending
    at the same states; sweep over rho x seed as one 4-member unit, every row
    ok. The counts of the ensemble run are slice 4a's launches. The members'
    final checkpoints are copied into ``keep`` for phase 35."""
    import shutil

    from pinns_tpu_torch.ops.kernels import fused_step as k_fused

    c = ENS_CLI
    n, preset = c["members"], "abgrall_admm"
    common = ["--preset", preset, "--device", "cuda", "--epochs", str(c["epochs"]),
              "--set", f"optimizer.switch_epoch={c['switch']}",
              "--set", f"optimizer.lbfgs.max_iters={c['lbfgs_iters']}",
              "--set", f"train.checkpoint_every={c['switch']}"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = lambda name: os.path.join(tmp, name)  # noqa: E731
        reset_counts()
        with PlainCalls() as plain:
            t0 = time.perf_counter()
            rc, lines = cli_lines(["train", *common, "--ensemble", str(n), "--select",
                                   "--out-dir", d("ens")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernel_counts()
        check(rc == 0, f"train --ensemble exited {rc}")
        check(plain.calls == 0, f"{plain.calls} calls of a plain version on the ensemble path")
        # K9 over K8: every Adam epoch of the members inside a replay
        check(launches["fused_chunk_epochs"] == c["switch"]
              and launches["fused_step_ensemble"] == launches["fused_step"] == 0,
              f"ensemble launches {launches}")
        check(launches["mlp_forward"] > 0 and launches["lbfgs_solves"] > 0
              and launches["fused_value_and_grad"] > 0 and launches["taylor2_backward"] == 0,
              f"the L-BFGS epochs ran off K10: {launches}")
        for i in range(n):
            shutil.copy(d(f"ens/{preset}_final_m{i}.ckpt"), keep)
        summaries, pick = lines[:n], lines[n]
        check([s["seed"] for s in summaries] == [1234 + i for i in range(n)]
              and all(s["epochs"] == c["epochs"] and math.isfinite(s["rel_l2_u"])
                      for s in summaries), f"member summaries {summaries}")
        check(0 <= pick["selected_member"] < n and len(pick["scores"]) == n
              and all(math.isfinite(s["score"]) for s in pick["scores"]), f"--select {pick}")
        solo = []
        for i in range(n):
            rc, sl = cli_lines(["train", *common, "--seed", str(1234 + i), "--out-dir", d(f"s{i}")])
            check(rc == 0, f"solo train exited {rc}")
            solo.append(sl[-1]["rel_l2_u"])
            check(same_state(d(f"ens/{preset}_final_m{i}.ckpt"), d(f"s{i}/{preset}_final.ckpt")),
                  f"member {i}'s final state differs from its solo run")
        rc, _ = cli_lines(["train", *common, "--ensemble", str(n), "--resume",
                           d(f"ens/{preset}_e{c['switch']}"), "--out-dir", d("res")])
        check(rc == 0, f"train --ensemble --resume exited {rc}")
        for i in range(n):
            check(same_state(d(f"ens/{preset}_final_m{i}.ckpt"), d(f"res/{preset}_final_m{i}.ckpt")),
                  f"member {i}: the resumed run ends elsewhere")
        before = k_fused.ENSEMBLE_LAUNCHES, k_fused.LAUNCHES, k_fused.GRAPH_EPOCHS
        rc, rows = cli_lines(["sweep", "--preset", preset, "--device", "cuda",
                              "--grid", "loss.rho=10,40", "--grid", "train.seed=1234,7",
                              "--epochs", str(c["sweep_epochs"]), "--out", d("sweep.jsonl")])
        sweep_k8 = k_fused.GRAPH_EPOCHS - before[2]
        check(rc == 0 and len(rows) == 4 and all(r["status"] == "ok" for r in rows),
              f"sweep: rc {rc}, rows {rows}")
        check(sweep_k8 == c["sweep_epochs"] and k_fused.LAUNCHES == before[1]
              and k_fused.ENSEMBLE_LAUNCHES == before[0],
              f"the sweep replayed {sweep_k8} K8 epochs and made "
              f"{k_fused.ENSEMBLE_LAUNCHES - before[0]} K8 and "
              f"{k_fused.LAUNCHES - before[1]} solo host calls")
    out.update(launches=launches, wall_s=wall)
    emit(card, phase="ensemble-cli", preset=preset, members=n, epochs=c["epochs"],
         switch=c["switch"], lbfgs_iters=c["lbfgs_iters"], wall_s=wall, launches=launches,
         rel_l2_u=[s["rel_l2_u"] for s in summaries], solo_rel_l2_u=solo,
         members_bit_equal_to_solo=True, resume_bit_equal=True,
         selected=pick["selected_member"], sweep_rows=rows, sweep_k8_epochs=sweep_k8)
    return out


def ensemble_bound(n: int):
    """K8's epoch for n members: n times K3's work and its per-member bytes;
    the data points read once."""
    one = taylor2_ops(NARROW, 1_000) * 4 + [(3 * 2.0 * sum(_macs(NARROW)) * 100, PEAK_FP32)]
    nbytes = n * (24 * n_params(NARROW) + 32 * 1_000) + 12 * 100
    return bound([(f * n, r) for f, r in one], nbytes)


def phase_ensemble_times(card: str) -> dict:
    """32: a K8 epoch (CUDA events) and a 1,000-epoch chunk's member-epochs a
    second at E = 1, 8 and 32 (the chunk replayed from K9's graphs, its
    epochs counted) beside the solo K3 step; the plain per-member loop at
    E = K8_MAIN."""
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.parallel import ensemble as ens
    from pinns_tpu_torch.train import trainer as tr

    trainer = tr.Trainer(get_preset("abgrall_admm"), device="cuda")
    state = trainer.init_state()
    solo_ms = event_ms(lambda: trainer._adam_step(state))
    tr.run_chunk(trainer._adam_step, state, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run_chunk(trainer._adam_step, state, 1000)
    torch.cuda.synchronize()
    solo_chunk = time.perf_counter() - t0
    emit(card, phase="times", what="k3_solo", net="8x20", epoch_ms=solo_ms, clock="cuda_events",
         chunk_wall_s=solo_chunk, epochs_per_s=1000 / solo_chunk)
    out = {"solo": (solo_ms, 1000 / solo_chunk)}
    k8 = k_fused.make_fused_ensemble_step(trainer.problem, trainer.learning_rate)
    for n in K8_TIMES:
        stacked = ens.init_ensemble_states(trainer, [1234 + i for i in range(n)])
        ms = event_ms(lambda: k8(stacked))
        chunk = ens.make_ensemble_chunk(trainer, 1000)
        ens.make_ensemble_chunk(trainer, 10)(stacked)
        torch.cuda.synchronize()
        before = k_fused.GRAPH_EPOCHS
        t0 = time.perf_counter()
        chunk(stacked)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = k_fused.GRAPH_EPOCHS - before
        check(calls == 1000, f"E={n}: {calls} replayed K8 epochs for 1,000 epochs")
        plain_ms = None
        if n == K8_MAIN:
            plain = tr.make_adam_step(trainer.problem, trainer.learning_rate, plain=True)
            members = ens.unstack_states(stacked)
            plain_ms = event_ms(lambda: [plain(m) for m in members])
        b = ensemble_bound(n)
        emit(card, phase="times", what="k8", net="8x20", members=n, epoch_ms=ms,
             clock="cuda_events", chunk_wall_s=wall, member_epochs_per_s=n * 1000 / wall,
             vs_solo_chunk=(n * 1000 / wall) / out["solo"][1], k8_replayed_epochs=calls,
             plain_member_loop_ms=plain_ms, bound_ms=b[0], bound_by=b[1])
        out[n] = (ms, n * 1000 / wall, plain_ms, b)
    return out


# -- 36 and times: K9, the fused step's chunk as captured CUDA graphs -----------
K9_NARROW_LENGTHS = (1, 2, 7, 1_000)  # abgrall_admm's 8x20 (the narrow K3)
K9_WIDE_LENGTHS = (1, 3, 50)  # abgrall_l1 (l1_sq_norm) and abgrall_admm at 8x200 (wide)
K9_MEMBERS = (1, 3, 8, 32)  # K8
K9_K8_EPOCHS = 7
K9_TURNS = 10  # alternating turns a side of the graphed and the per-epoch chunk
K9_CHUNK = 1_000
# the narrow K3's kernels in a graphed epoch (device microseconds) under the
# design of 64-point tiles (18 grad blocks, 16 tail blocks at N_f 1,000) that
# the 8-point tiles replaced: scripts/profile_train_step.py --graph on an
# NVIDIA H100 80GB HBM3 at 700 W; printed beside this run's
K9_PRIOR_US = {
    "8x20": {"grad_kernel": 87.3, "tail_kernel": 27.7, "adam_kernel": 4.5,
             "finalize_kernel": 1.9, "epoch_device": 121.4},
    "k8_e8": {"grad_kernel": 129.4, "epoch_device": 164.5},
    "k8_e32": {"grad_kernel": 309.6, "epoch_device": 386.7},
}


def hold_chunk(name: str, got, want) -> float:
    """A graphed chunk's (state, metrics) against the per-epoch loop's:
    torch.equal on every tensor (the params and Adam trees, z, dual, the
    batch; a stacked state's with its member axis) and every metrics row, the
    epoch and Adam's count equal; returns the largest |got - want| (0.0)."""
    from pinns_tpu_torch.opt.adam import tree_leaves
    from pinns_tpu_torch.train.trainer import METRIC_KEYS

    (sa, ma), (sb, mb) = got, want
    check(sa.epoch == sb.epoch and sa.opt_state.count == sb.opt_state.count,
          f"{name}: epoch or count differs")

    def leaves(s, m):
        admm = [] if s.admm is None else [s.admm.z, s.admm.dual]
        return tree_leaves([s.params, s.opt_state.mu, s.opt_state.nu, admm, s.colloc]) + [
            torch.stack([m[k] for k in METRIC_KEYS], -1)]

    a, b = leaves(sa, ma), leaves(sb, mb)
    check(len(a) == len(b), f"{name}: {len(a)} outputs vs {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        check(x.shape == y.shape and torch.equal(x, y),
              f"{name}: output {i} differs from the per-epoch loop")
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))


def phase_k9(card: str) -> dict:
    """36: K9, graphed chunks against per-epoch loops, bit for bit on params,
    mu, nu, colloc, z, dual and every metrics row: the narrow K3 at
    abgrall_admm's 8x20 for L = 1, 2, 7 and 1,000, and 2 x 500 against
    1 x 1,000; the wide K3 at 8x200 for l1_sq_norm (abgrall_l1) and admm
    (abgrall_admm with that net) at L = 1, 3 and 50; K8 at E = 1, 3, 8 and 32
    with distinct rhos and seeds, drawn and fed given points."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.parallel import ensemble as ens
    from pinns_tpu_torch.train import trainer as tr

    errs, rows = [], {}

    def held(name, got, want):
        errs.append(hold_chunk(name, got, want))
        rows[name] = True

    reset_counts()
    cases = [("8x20-admm", get_preset("abgrall_admm"), K9_NARROW_LENGTHS),
             ("8x200-l1_sq_norm", get_preset("abgrall_l1"), K9_WIDE_LENGTHS),
             ("8x200-admm", override(get_preset("abgrall_admm"), {"model.layers": WIDE}),
              K9_WIDE_LENGTHS)]
    for name, exp, lengths in cases:
        trainer = tr.Trainer(exp, device="cuda")
        run = trainer._get_chunk("adam")
        check(getattr(run, "runner", None) is not None, f"{name}: the chunk is not graphed")
        state = trainer.init_state()
        for length in lengths:
            held(f"{name}-L{length}", run(state, length),
                 tr.run_chunk(trainer._adam_step, state, length))
        if name == "8x20-admm":
            half = run(state, K9_CHUNK // 2)
            rest = run(half[0], K9_CHUNK // 2)
            whole = run(state, K9_CHUNK)
            two = (rest[0], {k: torch.cat([half[1][k], rest[1][k]]) for k in rest[1]})
            held("8x20-admm-2x500-vs-1x1000", two, whole)
    trainer = tr.Trainer(get_preset("abgrall_admm"), device="cuda")
    k8 = k_fused.make_fused_ensemble_step(trainer.problem, trainer.learning_rate)
    n_f = trainer.exp.sampling.n_f
    for n in K9_MEMBERS:
        stacked = ens.init_ensemble_states(trainer, *k8_members(n))
        feed = points(K9_K8_EPOCHS * n * n_f, seed=36 + n, device="cuda").view(
            K9_K8_EPOCHS, n, n_f, 2)
        for fed in (None, feed):
            tag = f"k8-e{n}-{'fed' if fed is not None else 'drawn'}"
            held(tag, ens.make_ensemble_chunk(trainer, K9_K8_EPOCHS)(stacked, new_colloc=fed),
                 tr.run_chunk(k8, stacked, K9_K8_EPOCHS, fed))
    counts = kernel_counts()
    emit(card, phase="k9", criterion="torch.equal of every output and metrics row vs the "
         "per-epoch loop", cases=rows, max_abs_err=max(errs),
         fused_chunk_replays=counts["fused_chunk_replays"],
         fused_chunk_epochs=counts["fused_chunk_epochs"])
    return {"max_abs_err": max(errs)}


def k3_kernel_us(fn, epochs: int) -> dict:
    """Device microseconds an epoch of each K3 kernel (its name in namespace
    k3) in one call of ``fn``, a chunk of ``epochs`` epochs, by
    torch.profiler; "epoch_device" their sum."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        if us > 0 and "k3::" in evt.key:
            name = evt.key.split("k3::")[1].split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + us / epochs
    check(bool(out), "the profiler saw no K3 kernel on the device")
    out["epoch_device"] = sum(out.values())
    return out


def phase_k9_times(card: str) -> dict:
    """times: 1,000-epoch chunks graphed (K9) against the per-epoch loop in
    K9_TURNS alternating turns a side (host clock, each chunk ending in a
    synchronize): epochs a second at 8x20 (abgrall_admm) and 8x200
    (abgrall_l1), member-epochs a second for K8 at E 8 and 32; the one-off
    capture time (warm-up epoch and both graphs), the replays and replayed
    epochs of the graphed turns; each beside the chunk's bound (the epoch's
    bound times 1,000). At 8x20 and for K8, one more graphed chunk under
    torch.profiler gives each narrow kernel's device time an epoch, beside
    its bound and the 64-point design's (K9_PRIOR_US)."""
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.parallel import ensemble as ens
    from pinns_tpu_torch.train import trainer as tr

    cells = {}
    for name, preset in (("8x20", "abgrall_admm"), ("8x200", "abgrall_l1")):
        trainer = tr.Trainer(get_preset(preset), device="cuda")
        state = trainer.init_state()
        run = trainer._get_chunk("adam")
        layers, n_f = trainer.problem.spec.layers, trainer.exp.sampling.n_f
        b = step_bound(layers, n_f, trainer.exp.data.n_u)
        cells[name] = (1, run.runner, lambda run=run, state=state: run(state, K9_CHUNK),
                       lambda trainer=trainer, state=state: tr.run_chunk(
                           trainer._adam_step, state, K9_CHUNK), (b[0] * K9_CHUNK, b[1]))
    trainer = tr.Trainer(get_preset("abgrall_admm"), device="cuda")
    k8 = k_fused.make_fused_ensemble_step(trainer.problem, trainer.learning_rate)
    for n in (K8_MAIN, 32):
        stacked = ens.init_ensemble_states(trainer, *k8_members(n))
        chunk = ens.make_ensemble_chunk(trainer, K9_CHUNK)
        b = ensemble_bound(n)
        cells[f"k8_e{n}"] = (n, None, lambda chunk=chunk, stacked=stacked: chunk(stacked),
                             lambda stacked=stacked: tr.run_chunk(k8, stacked, K9_CHUNK),
                             (b[0] * K9_CHUNK, b[1]))
    out = {}
    for name, (n, runner, graphed, loop, b) in cells.items():
        graphed()  # captures (the trainer's runner, or K8's for this member count)
        loop()
        torch.cuda.synchronize()
        if runner is None:
            runner = ens.k8_chunk(trainer, n)
        reset_counts()
        times = {"graphed": [], "per_epoch": []}
        for turn in range(K9_TURNS):
            order = (("graphed", graphed), ("per_epoch", loop))
            for side, fn in (order if turn % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[side].append(time.perf_counter() - t0)
        counts = kernel_counts()
        check(counts["fused_chunk_epochs"] == K9_TURNS * K9_CHUNK,
              f"{name}: {counts['fused_chunk_epochs']} replayed epochs")
        ms = {k: 1e3 * statistics.median(v) for k, v in times.items()}
        rate = {k: n * K9_CHUNK / (v / 1e3) for k, v in ms.items()}
        kernels = {}
        if name in K9_PRIOR_US:
            us = k3_kernel_us(graphed, K9_CHUNK)
            kernels = {"kernel_us": us, "prior_64_point_design_us": K9_PRIOR_US[name],
                       **narrow_bound_fields(n), "kernel_clock": "torch.profiler (device)"}
        emit(card, phase="times", what="k9_chunk", cell=name, members=n, epochs=K9_CHUNK,
             turns=K9_TURNS, clock="host", graphed_ms=ms["graphed"],
             per_epoch_ms=ms["per_epoch"], graphed_per_s=rate["graphed"],
             per_epoch_per_s=rate["per_epoch"], unit="member-epochs" if n > 1 else "epochs",
             speedup=ms["per_epoch"] / ms["graphed"], graphed_s=times["graphed"],
             per_epoch_s=times["per_epoch"], capture_s=runner.capture_seconds[0],
             replays=counts["fused_chunk_replays"], replayed_epochs=counts["fused_chunk_epochs"],
             bound_ms=b[0], bound_by=b[1], **kernels)
        out[name] = (ms["graphed"], ms["per_epoch"], b, runner.capture_seconds[0],
                     kernels.get("kernel_us"))
    return out


# -- 33-35: serving an ensemble (K8s: the member-batched K1, the reduction) -----

ENS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "ensemble_serve.npz")
K8S_MEMBERS = (1, 3, 8)
K8S_NS = (1, 31, 25_600)
K8S_MAIN = (NARROW, 8, 25_600)  # the kernels line's K8s (a): phase 35's Burgers shape, E 8
K8S_REDUCE = (8, 47_100, 6, 3)  # and (c): the Euler ensemble's E, N, fields, dx fields
# (c) at each member bucket (<= 8, 16, 32 in registers; 33 two reads), and
# at E 8 with N C odd (scalar loads) and at 7 points
K8S_REDUCE_MEMBERS = (1, 3, 8, 16, 32, 33)
REDUCE_REPS = 200
ENS_EULER = {"members": 8, "epochs": 300}  # phase 35's euler_weak_fast ensemble


def net_of(flat: np.ndarray, spec) -> list:
    """JAX-layout numpy params from a flat vector in the port's order."""
    from pinns_tpu_torch.ops.kernels.taylor2 import nets_from_flat

    nets = nets_from_flat(spec, torch.from_numpy(np.ascontiguousarray(flat[None])))
    return [{k: v.numpy() for k, v in layer.items()} for layer in nets[0]]


def reduce_inputs(e: int, n: int, c: int, cd: int, seed: int, device):
    """Members that agree to 1e-4 (a one-pass variance would cancel)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((1, n, c))
    vals = (base + 1e-4 * rng.standard_normal((e, n, c))).astype(np.float32)
    dx = rng.standard_normal((e, n, cd)).astype(np.float32)
    return torch.from_numpy(vals).to(device), torch.from_numpy(dx).to(device)


def reduce_bound(e: int, n: int, c: int, cd: int):
    """K8s (c): the stacks read once, mean, std and dx written once; ~4 E
    flops a value."""
    return bound([(4.0 * e * n * (c + cd), PEAK_FP32)], 4 * e * n * (c + cd) + 4 * n * (2 * c + cd))


def members_bound(layers, e: int, n: int):
    """K8s (a): E solo K1 calls' operations; x read once, E nets and E x 4
    streams."""
    ops = [(f * e, r) for f, r in taylor2_ops(layers, n)]
    return bound(ops, 8 * n + 16 * n * layers[-1] * e + 4 * n_params(layers) * e)


def phase_k8s(card: str) -> dict:
    """33: K8s (a) at 8x20 (narrow) and 8x200 (tiled), E = 1, 3, 8, N = 1,
    31, 25,600: every member's four streams equal a solo K1 call (torch.equal);
    (c) against float64 by compare_f64 at E = 3 and 8 on the Euler ensemble's
    shape."""
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels import ensemble as k_ens
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.parallel.ensemble import pack_members

    out = {}
    for layers in (NARROW, WIDE):
        spec = MLPSpec(layers=layers, lb=LB, ub=UB)
        nets = [init_mlp(spec, torch.Generator().manual_seed(330 + m), "cuda") for m in range(8)]
        for e in K8S_MEMBERS:
            flat = pack_members(nets[:e])
            for n in K8S_NS:
                x = points(n, seed=331 + n, device="cuda")
                with torch.inference_mode():
                    before = k_taylor2.MEMBER_LAUNCHES
                    got = k_taylor2.taylor2_members(spec, flat, x)
                    solo = [k_taylor2.taylor2(spec, net, x) for net in nets[:e]]
                    torch.cuda.synchronize()
                check(k_taylor2.MEMBER_LAUNCHES == before + 1, "K8s (a) is one launch a call")
                for m in range(e):
                    check(all(torch.equal(g[m], s) for g, s in zip(got, solo[m])),
                          f"K8s (a) {len(layers) - 2}x{max(layers)} E={e} N={n}: member {m} "
                          "differs from its solo K1 call")
                if (layers, e, n) == K8S_MAIN:
                    with torch.inference_mode():
                        plain = k_taylor2.taylor2_members_reference(spec, flat, x)
                    out["members_err"] = max(float((g - p).abs().max())
                                             for g, p in zip(got, plain))
        emit(card, phase="k8s", part="a", net=f"{len(layers) - 2}x{max(layers)}",
             members=K8S_MEMBERS, n=K8S_NS, bit_equal_to_solo_k1=True,
             launch=dataclasses.asdict(k_taylor2.launch_config(layers)))
    e_main, n, c, cd = K8S_REDUCE
    for e, n_e in [(e, n) for e in K8S_REDUCE_MEMBERS] + [(e_main, n + 1), (e_main, 7)]:
        vals, dx = reduce_inputs(e, n_e, c, cd, seed=333 + e, device="cuda")
        with torch.inference_mode():
            got = k_ens.member_stats(vals, dx)
            plain = k_ens.member_stats_reference(vals, dx)
            exact = k_ens.member_stats_reference(vals.double(), dx.double())
            spelled = member_stats_spelled(vals, dx)
            torch.cuda.synchronize()
        rows = {name: compare_f64(f"K8s (c) {name} E={e}", host(g), host(p), host(x))
                for name, g, p, x in zip(("mean", "std", "dx"), got, plain, exact)}
        check(all(torch.equal(g, w) for g, w in zip(got, spelled)),
              f"K8s (c) at E {e}, N {n_e} differs from its arithmetic spelled in member order")
        if (e, n_e) == (e_main, n):
            out["reduce_err"] = max(r["max_abs_err_vs_plain"] for r in rows.values())
        emit(card, phase="k8s", part="c", members=e, n=n_e, fields=c, dx_fields=cd,
             criterion="compare_f64", rows=rows, equal_to_spelled_member_order=True)
    return out


def member_stats_spelled(vals, dx):
    """K8s (c)'s arithmetic in plain PyTorch, one float32 op a kernel in
    member order (no contraction): the sum, / E, the squared deviations'
    sum, / E, sqrt; |the dx sum / E|."""
    e = vals.shape[0]
    s = torch.zeros_like(vals[0])
    for k in range(e):
        s = s + vals[k]
    # a tensor divisor: PyTorch divides by a CPU scalar as a product with its
    # reciprocal, which is not the division the kernel does
    fe = torch.full_like(s, e)
    mu = s / fe
    q = torch.zeros_like(mu)
    for k in range(e):
        t = vals[k] - mu
        q = q + t * t
    sd = torch.zeros_like(dx[0])
    for k in range(e):
        sd = sd + dx[k]
    return mu, torch.sqrt(q / fe), torch.abs(sd / torch.full_like(sd, e))


def served_fixture_ensemble(fx: dict, kind: str):
    """The fixture's members as JAX-layout nets, and their coefficients."""
    from pinns_tpu_torch.models.mlp import MLPSpec

    paths = {}
    if f"{kind}_n_paths" in fx:
        paths = {"n_paths": int(fx[f"{kind}_n_paths"]),
                 "path_degree": int(fx[f"{kind}_path_degree"]),
                 "path_sharpness": float(fx[f"{kind}_path_sharpness"])}
    spec = MLPSpec(layers=tuple(int(v) for v in fx[f"{kind}_layers"]),
                   lb=tuple(fx[f"{kind}_lb"]), ub=tuple(fx[f"{kind}_ub"]), **paths)
    nets = [net_of(f, spec) for f in fx[f"{kind}_params"]]
    return spec, nets, [float(v) for v in fx[f"{kind}_lambda1"]], \
        [float(v) for v in fx[f"{kind}_lambda2"]]


def hold_rows(name: str, got: dict, want: dict, n: int, windows: dict) -> dict:
    """A calibration row of the port's predictions against JAX's. k_conf95
    and each mond_k within rtol 1e-3 of JAX's, or inside its window
    (``quantile_windows``): a quantile picks one score, and where members
    agree to 1e-4 the std, a difference, carries float32 noise of 1e-3 of
    itself, so the pick moves as far as the scores around it move. k95 rtol
    1e-3; mond_edges and the rest rtol 1e-4. Coverages within 2/n + 1e-3: a
    point whose error lies within float32 noise of its band's edge k std
    flips, as a point near a Mondrian edge changes its bin, and no more
    than 0.1% of the points may (the grid's 47,100 Euler points put five
    such flips into cov_conf95 of E on the CPU's plain versions alone).
    Every key is held before the first failure raises."""
    check(sorted(got) == sorted(want), f"{name}: keys {sorted(got)} vs {sorted(want)}")
    worst, bad, by_window = 0.0, [], []
    for k, w in want.items():
        g = got[k]
        if k == "mond_feature":
            check(g == w, f"{name} {k}")
            continue
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if k.startswith("cov"):
            ok = bool(np.all(np.abs(g - w) <= 2.0 / n + 1e-3))
        else:
            rtol = 1e-3 if k in ("k_conf95", "k95", "mond_k") else 1e-4
            close_ = np.abs(g - w) <= rtol * np.abs(w)
            ok = bool(np.all(close_))
            if not ok and k in windows:
                lo, hi = (np.asarray(v, np.float64) for v in windows[k])
                ok = bool(np.all(close_ | ((g >= lo) & (g <= hi))))
                by_window += [k] if ok else []
            worst = max(worst, float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30))))
        if not ok:
            bad.append(f"{k}: port {g.tolist()} vs JAX {w.tolist()}, window "
                       f"{[np.asarray(v).tolist() for v in windows.get(k, ())]}")
    check(not bad, f"{name}: {bad}")
    return {"max_rel_err": worst, "held_by_window": by_window}


def quantile_windows(kind: str, fx: dict, grid: dict, exact: dict, feature: str,
                     alpha: float = 0.05, n_bins: int = 4) -> dict:
    """Per network field, the windows of k_conf95 and mond_k: calibration_
    stats's quantiles (method 'higher') of JAX's scores s over its
    calibration subset, each score moved down and up by d, how far it moves
    between JAX's predictions and the port's (s = |mean - exact| / (std +
    1e-12)). A quantile is monotone in the scores, so the port's, over the
    same points, lies in [q(s - d), q(s + d)]; mond_k's bins are JAX's (its
    feature at those points over its edges). The two packages' mean and std
    at the subset are first held as the served outputs are."""
    idx = fx[f"{kind}_cal_idx"]
    m = idx.size
    level = min(1.0, math.ceil((m + 1) * (1.0 - alpha)) / m)
    q = lambda v, lvl: float(np.quantile(v, lvl, method="higher"))  # noqa: E731
    out = {}
    for j, field in enumerate(str(f) for f in fx[f"{kind}_cal_fields"]):
        ex = np.asarray(exact[field], np.float64)[idx, 0]
        mp, sp = (np.asarray(grid[field][s], np.float64)[idx, 0] for s in ("mean", "std"))
        mj, sj, dxj = (np.asarray(fx[f"{kind}_cal_{s}"], np.float64)[:, j]
                       for s in ("mean", "std", "dx"))
        scale = float(np.abs(mj).max())
        check(bool(np.all(np.abs(mp - mj) <= 1e-5 * scale + 1e-5 * np.abs(mj))) and
              bool(np.all(np.abs(sp - sj) <= 1e-5 * scale)),
              f"{kind} {field}: the calibration subset's mean or std off JAX's")
        s_j = np.abs(mj - ex) / (sj + 1e-12)
        d = np.abs(np.abs(mp - ex) / (sp + 1e-12) - s_j)
        k_win = (q(s_j - d, level), q(s_j + d, level))
        feat = dxj if feature == "dx" else sj
        edges = np.quantile(feat[: m // 2], np.linspace(0.0, 1.0, n_bins + 1)[1:-1])
        half = np.arange(m // 2, m)
        bins = np.searchsorted(edges, feat[half], side="right")
        lo, hi = [], []
        for b in range(n_bins):
            sel = half[bins == b]
            if sel.size >= 20:
                lvl = min(1.0, math.ceil((sel.size + 1) * (1.0 - alpha)) / sel.size)
                lo.append(q(s_j[sel] - d[sel], lvl))
                hi.append(q(s_j[sel] + d[sel], lvl))
            else:
                lo.append(k_win[0])
                hi.append(k_win[1])
        out[field] = {"k_conf95": k_win, "mond_k": (lo, hi)}
    return out


def phase_ens_fixture(card: str) -> dict:
    """34: the committed JAX fixture's ensembles (Burgers 8x20 E 4, the
    full-width euler_weak_fast trunk with two shock paths E 3) through the
    port's uq_calibration on the card against JAX's rows (hold_rows), then
    exported and served (ServedModel on the card): mean, std and dx against
    JAX's ensemble_predict, the Mondrian bins at the served points against
    JAX's."""
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.interop import params_from_jax
    from pinns_tpu_torch.parallel import ensemble as ens
    from pinns_tpu_torch.serve import ServedModel, export_ensemble
    from pinns_tpu_torch.train.trainer import Trainer

    with np.load(ENS_FIXTURE, allow_pickle=False) as z:
        fx = {k: z[k] for k in z.files}
    out = {}
    for kind in ("burgers", "euler"):
        preset = str(fx[f"{kind}_preset"])
        trainer = Trainer(get_preset(preset), device="cuda")
        spec, nets, lam1, lam2 = served_fixture_ensemble(fx, kind)
        check(np.allclose(trainer.problem.spec.lb, spec.lb) and
              np.allclose(trainer.problem.spec.ub, spec.ub), f"{kind}: grid bounds differ")
        stacked = types.SimpleNamespace(params=ens.stack_params([
            {"net": params_from_jax(net, trainer.device),
             "coeffs": {"lambda1": torch.tensor([a], device=trainer.device),
                        "lambda2": torch.tensor([b], device=trainer.device)}}
            for net, a, b in zip(nets, lam1, lam2)]))
        want_cal = json.loads(str(fx[f"{kind}_calibration"]))
        ds = trainer.problem.dataset
        grid = ens.ensemble_predict(trainer, stacked, ds.X_star)
        rows = {}
        cal = {}
        for feature in ("std", "dx"):
            cal[feature] = ens.uq_calibration(trainer, stacked, mond_feature=feature)
            windows = quantile_windows(kind, fx, grid, ds.star, feature)
            for field, row in cal[feature].items():
                rows[f"{field}/{feature}"] = hold_rows(f"{kind} {field} {feature}", row,
                                                        want_cal[feature][field], ds.n_points,
                                                        windows[field])
        with tempfile.TemporaryDirectory() as tmp:
            art = export_ensemble(spec, nets, os.path.join(tmp, "ens"), lam1, lam2,
                                  experiment=preset, pde=trainer.exp.pde.kind,
                                  gamma=trainer.exp.pde.gamma, calibration=cal["dx"])
            served = ServedModel(art, device="cuda")
            x = fx[f"{kind}_x"]
            reset_counts()
            got = served.predict(x, pad_to_bucket=True)
            launches = kernel_counts()
        check(launches["member_stats"] == 1 and launches["taylor1"] == len(nets)
              and launches["taylor2_members"] == (1 if kind == "burgers" else 0),
              f"{kind}: served launches {launches}")
        errs = {}
        for k, g in got.items():
            # mean and dx rtol 1e-5 / atol 1e-5 max|JAX| (1e-4 for the
            # residuals f, f1..f3); the std, a difference, atol alone, of
            # the max|mean| of its field
            name, _, what = k.partition("_")
            want = fx[f"{kind}_{name}_{what or 'mean'}"]
            scale = float(np.abs(want if what == "dx" else fx[f"{kind}_{name}_mean"]).max())
            atol = (1e-4 if name.startswith("f") else 1e-5) * scale
            err = np.abs(np.asarray(g, np.float64) - want)
            rtol_part = 0.0 if what == "std" else 1e-5 * np.abs(want)
            check(bool(np.all(err <= atol + rtol_part)),
                  f"{kind} {k}: max err {float(err.max())} > atol {atol}")
            errs[k] = float(err.max())
        moved = {}
        for field, row in want_cal["dx"].items():
            edges = np.asarray(row["mond_edges"])
            fj, fp = fx[f"{kind}_{field}_dx"].ravel(), got[f"{field}_dx"].ravel()
            bins = np.searchsorted(edges, fp, side="right") != np.searchsorted(edges, fj,
                                                                                side="right")
            near = np.min(np.abs(fj[:, None] - edges[None, :]), axis=1) <= \
                1e-4 * np.abs(edges).max() + 1e-5 * np.abs(fj).max()
            check(not np.any(bins & ~near) and bins.sum() <= 1e-3 * fj.size,
                  f"{kind} {field}: {int(bins.sum())} points changed their Mondrian bin")
            moved[field] = int(bins.sum())
        out[kind] = max(errs.values())
        emit(card, phase="ens-fixture", ensemble=kind, preset=preset, members=len(nets),
             net=f"{len(spec.layers) - 2}x{max(spec.layers)}", paths=spec.n_paths,
             n=int(x.shape[0]), max_abs_err=errs, calibration=rows, bins_moved=moved,
             launches={k: v for k, v in launches.items() if v})
    return out


def serve_checks(art: str, point_art: str, x: np.ndarray, fields) -> dict:
    """The HTTP server over an ensemble artifact on the card: /meta, bands by
    JSON and by npy equal to the served model's own, and a 400 for bands on
    a point artifact."""
    from pinns_tpu_torch.serve import ServedModel, make_http_server

    served = ServedModel(art, device="cuda")
    want = served.add_bands(served.predict(x, pad_to_bucket=True))
    check(all(f"{f}_band" in want for f in fields), f"bands {sorted(want)}")
    out = {}
    for path in (art, point_art):
        server = make_http_server(path, port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://127.0.0.1:%d" % server.server_address[1]
            if path == point_art:
                code, _, body = http(base + "/predict", json.dumps(
                    {"x": x[:4].tolist(), "bands": True}).encode())
                check(code == 400 and "calibration" in json.loads(body)["error"],
                      f"bands on a point artifact answered {code}")
                out["point_bands_status"] = code
                continue
            code, _, body = http(base + "/meta")
            check(code == 200 and json.loads(body) == served.meta, "GET /meta")
            code, _, body = http(base + "/predict", json.dumps(
                {"x": x[:8].tolist(), "bands": True}).encode())
            check(code == 200, f"JSON bands answered {code}: {body[:200]!r}")
            w8 = served.add_bands(served.predict(x[:8], pad_to_bucket=True))
            got = {k: np.asarray(v, np.float32) for k, v in json.loads(body).items()}
            check(sorted(got) == sorted(w8) and all(
                np.array_equal(got[k], np.asarray(w8[k], np.float32)) for k in w8),
                "JSON bands differ")
            buf = io.BytesIO()
            np.save(buf, x)
            code, ctype, body = http(base + "/predict?bands=1", buf.getvalue(),
                                     "application/x-npy")
            check(code == 200 and ctype == "application/x-npz", f"npy bands answered {code}")
            with np.load(io.BytesIO(body)) as z:
                check(sorted(z.files) == sorted(want) and all(
                    np.array_equal(z[k], np.asarray(want[k], np.float32)) for k in want),
                    "npy bands differ")
            out.update(json_points=8, npy_points=int(x.shape[0]))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "HTTP server thread did not stop")
    return out


def serve_ensemble_cli(tmp: str, preset: str, ckpts, sets, features, x) -> dict:
    """export --calibrate for each Mondrian feature, predict --bands and eval
    --artifact on each artifact, the CLI in this process."""
    from pinns_tpu_torch.train.evaluate import DX_FIELDS

    out = {}
    pts = os.path.join(tmp, f"{preset}_pts.npz")
    np.savez(pts, x=x)
    for feature in features:
        art = os.path.join(tmp, f"{preset}_{feature}")
        rc, rows = cli_lines(["export", "--preset", preset, *sets, "--checkpoint", *ckpts,
                              "--calibrate", "--mond-feature", feature, "--out", art,
                              "--device", "cuda"])
        check(rc == 0 and [r["field"] for r in rows] == list(DX_FIELDS[
            "euler" if preset.startswith("euler") else "burgers"]), f"export rows {rows}")
        check(all(r["mond_feature"] == feature and math.isfinite(r["k_conf95"]) for r in rows),
              f"calibration rows {rows}")
        pred = os.path.join(tmp, f"{preset}_{feature}_pred.npz")
        rc, _ = cli_lines(["predict", "--artifact", art, "--points", pts, "--out", pred,
                           "--bands", "--device", "cuda"])
        check(rc == 0, f"predict --bands exited {rc}")
        with np.load(pred) as z:
            bands = {k: z[k] for k in z.files if k.endswith("_band")}
        check(len(bands) == len(rows) and all(
            b.shape == (x.shape[0], 1) and bool(np.isfinite(b).all()) and bool((b >= 0).all())
            for b in bands.values()), f"predict --bands gave {sorted(bands)}")
        graded = cli_json(["eval", "--artifact", art, *sets, "--device", "cuda"])
        covs = {k: v for k, v in graded.items() if k.startswith("band_cov")}
        check(len(covs) == 2 * len(rows) and all(0.0 <= v <= 1.0 for v in covs.values()),
              f"eval --artifact band keys {graded}")
        out[feature] = {"artifact": art, "k_conf95": {r["field"]: r["k_conf95"] for r in rows},
                        "eval": {k: v for k, v in graded.items()
                                 if k.startswith(("band_", "rel_l2_"))}}
    return out


def phase_ensemble_serve(card: str, ckpt_dir: str, tmp: str) -> dict:
    """35: this slice's main path, the CLI and the HTTP server on the card,
    no plain call: phase 31's four abgrall_admm members -> export --calibrate
    (--mond-feature std and dx) -> predict --bands -> eval --artifact -> HTTP
    (bands by JSON and npy; a 400 for bands on phase 4's point artifact);
    then train euler_weak_fast --ensemble 8 for ENS_EULER epochs (the member
    loop) -> export --calibrate --mond-feature dx at the 47,100 grid points
    -> the same serving checks -> export --select rank --anchor (the same
    members) with meta['selection']. The counts of this run are the slice's
    launches."""
    from pinns_tpu_torch.data.datasets import load_burgers_mat, load_euler_mat

    point_art = os.path.join(tmp, "point")
    cli_json(["export", "--params", FIXTURE, "--out", point_art])
    burgers = [os.path.join(ckpt_dir, f"abgrall_admm_final_m{i}.ckpt")
               for i in range(ENS_CLI["members"])]
    c = ENS_EULER
    reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        xb = load_burgers_mat("twosin_burgers_shock").X_star
        rb = serve_ensemble_cli(tmp, "abgrall_admm", burgers, [], ("std", "dx"), xb)
        hb = serve_checks(rb["dx"]["artifact"], point_art, xb[:4_096], ("u",))
        burgers_launches = kernel_counts()
        t1 = time.perf_counter()
        rc, lines = cli_lines(["train", "--preset", PATH_PRESET, "--ensemble", str(c["members"]),
                               "--epochs", str(c["epochs"]), "--device", "cuda",
                               "--out-dir", os.path.join(tmp, "ewf")])
        check(rc == 0 and len(lines) == c["members"], f"train --ensemble exited {rc}")
        t2 = time.perf_counter()
        members = [os.path.join(tmp, "ewf", f"{PATH_PRESET}_final_m{i}.ckpt")
                   for i in range(c["members"])]
        xe = load_euler_mat("abgrall_eulers").X_star
        re_ = serve_ensemble_cli(tmp, PATH_PRESET, members, [], ("dx",), xe)
        he = serve_checks(re_["dx"]["artifact"], point_art, xe[:4_096], ("rho", "u", "E"))
        sel_art = os.path.join(tmp, "selected")
        rc, sel = cli_lines(["export", "--preset", PATH_PRESET, "--checkpoint", *members,
                             "--select", "rank", "--anchor", *members, "--out", sel_art,
                             "--device", "cuda"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    launches = kernel_counts()
    check(rc == 0 and sel[-1]["by"] == "rank" and 0 <= sel[-1]["selected"] < c["members"],
          f"export --select: {sel}")
    with open(os.path.join(sel_art, "meta.json")) as f:
        selection = json.load(f)["selection"]
    check(selection["selected"] == sel[-1]["selected"] and selection["anchor"] == members
          and len(selection["scores"]) == c["members"], f"meta['selection'] {selection}")
    check(plain.calls == 0, f"{plain.calls} calls of a plain version on the serving path")
    check(burgers_launches["taylor2_members"] > 0 and burgers_launches["member_stats"] > 0
          and burgers_launches["taylor1"] > 0
          and burgers_launches["taylor1_narrow"] == burgers_launches["taylor1"],
          f"Burgers serving launches {burgers_launches}")
    check(launches["member_stats"] > burgers_launches["member_stats"]
          and launches["taylor1"] > burgers_launches["taylor1"],
          f"Euler serving launches {launches}")
    emit(card, phase="ensemble-serve", burgers={"members": len(burgers), **rb, "http": hb},
         euler={"preset": PATH_PRESET, **c, "train_s": t2 - t1,
                "rel_l2": [{k: v for k, v in ln.items() if k.startswith("rel_l2")}
                           for ln in lines], **re_, "http": he,
                "selected": sel[-1]["selected"]},
         launches=launches, burgers_launches=burgers_launches, plain_calls=plain.calls,
         wall_s={"burgers": t1 - t0, "euler": t3 - t1})
    return {"launches": launches, "burgers_art": rb["dx"]["artifact"],
            "euler_art": re_["dx"]["artifact"]}


def phase_ens_serve_times(card: str, serve: dict) -> dict:
    """times: served ensemble predict (host clock, medians) at 25,600 points
    (Burgers, E 8: the fixture's members and four more) and 47,100 (Euler,
    phase 35's E 8), with and without bands; K8s (a) against E solo K1 calls
    and the plain version, and (c) beside its bound and torch.std_mean, by
    CUDA events."""
    from pinns_tpu_torch.data.datasets import load_euler_mat
    from pinns_tpu_torch.models.mlp import MLPSpec
    from pinns_tpu_torch.ops.kernels import ensemble as k_ens
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.parallel.ensemble import pack_members
    from pinns_tpu_torch.interop import params_from_jax
    from pinns_tpu_torch.serve import ServedModel, export_ensemble

    with np.load(ENS_FIXTURE, allow_pickle=False) as z:
        fx = {k: z[k] for k in z.files}
    spec, nets, lam1, lam2 = served_fixture_ensemble(fx, "burgers")
    rng = np.random.default_rng(350)
    nets = nets + [[{k: (v * (1.0 + 0.01 * rng.standard_normal(v.shape))).astype(np.float32)
                     for k, v in layer.items()} for layer in nets[0]] for _ in range(4)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cal = json.loads(str(fx["burgers_calibration"]))["dx"]
        art = export_ensemble(spec, nets, os.path.join(tmp, "b8"), lam1 * 2, lam2 * 2,
                              experiment="burgers_forward", calibration=cal)
        cases = (("burgers", art, fx["burgers_x"]),
                 ("euler", serve["euler_art"], load_euler_mat("abgrall_eulers").X_star))
        for kind, path, x in cases:
            served = ServedModel(path, device="cuda")
            plain_ms = host_ms(lambda: served.predict(x, pad_to_bucket=True))
            bands_ms = host_ms(lambda: served.add_bands(served.predict(x, pad_to_bucket=True)))
            out[kind] = (plain_ms, bands_ms)
            emit(card, phase="times", what="served_ensemble_predict", ensemble=kind,
                 members=served.members, n=int(x.shape[0]), ms=plain_ms, bands_ms=bands_ms,
                 points_per_s=x.shape[0] / (plain_ms / 1e3), reps=REPS, clock="host")
    layers, e, n = K8S_MAIN
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    tnets = [params_from_jax(net, "cuda") for net in nets[:e]]
    flat = pack_members(tnets)
    x = points(n, seed=351, device="cuda")
    with torch.inference_mode():
        ms = event_ms(lambda: k_taylor2.taylor2_members(spec, flat, x))
        solo_ms = event_ms(lambda: [k_taylor2.taylor2(spec, net, x) for net in tnets])
        plain_ms = event_ms(lambda: k_taylor2.taylor2_members_reference(spec, flat, x))
    b = members_bound(layers, e, n)
    out["members"] = (ms, plain_ms, b, solo_ms)
    emit(card, phase="times", what="k8s_members", net="8x20", members=e, n=n, kernel_ms=ms,
         solo_k1_calls_ms=solo_ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
         reps=REPS, clock="cuda_events")
    e, n, c, cd = K8S_REDUCE
    vals, dx = reduce_inputs(e, n, c, cd, seed=352, device="cuda")
    with torch.inference_mode():
        # launch- and host-bound calls of a few microseconds of device time:
        # in turns, REDUCE_REPS rounds
        ms, plain_ms, lib_ms = event_ms_turns(
            [lambda: k_ens.member_stats(vals, dx), lambda: k_ens.member_stats_reference(vals, dx),
             lambda: torch.std_mean(vals, dim=0, correction=0)], REDUCE_REPS)
    b = reduce_bound(e, n, c, cd)
    out["reduce"] = (ms, plain_ms, b, lib_ms)
    emit(card, phase="times", what="k8s_reduce", members=e, n=n, fields=c, dx_fields=cd,
         kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
         library="torch.std_mean over dim 0 (mean and std only, no dx)", bound_ms=b[0],
         bound_by=b[1], reps=REDUCE_REPS, clock="cuda_events, in turns")
    return out


# -- 37: K10, the L-BFGS solve on the device -------------------------------------

K10_TURNS = 5  # alternating long solves a side (K10, the host loop) for the times
K10_REPS = 20  # launches a kernel's device time is averaged over
K10_WIDE = 31_811  # the scope's largest net: 32 layers of width 32 and two coefficients
PROFILE_TRIES = 3  # profiler windows tried before a device time is "not measured"


def device_profile(fn) -> dict:
    """torch.profiler over one call of ``fn``: the device microseconds and
    launches of every kernel by name (copies apart), and their sums. A
    window that records no device activity (CUPTI has dropped a short
    window's events on the card) is run again, PROFILE_TRIES times in all;
    then every field is None: not measured."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels, copies = {}, 0.0
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            us = evt.self_cuda_time_total if us is None else us
            if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if evt.key.startswith(("Memcpy", "Memset")):
                copies += us
            else:
                kernels[evt.key] = {"us": us, "launches": evt.count}
        if kernels:
            return {"device_us": sum(k["us"] for k in kernels.values()) + copies,
                    "copies_us": copies, "kernels": sum(k["launches"] for k in kernels.values()),
                    "by_name": kernels}
    return {"device_us": None, "copies_us": None, "kernels": None, "by_name": {}}


def kernel_name(key: str) -> str:
    """A profiler key without its anonymous namespace and its arguments."""
    return key.replace("(anonymous namespace)::", "").split("(")[0]


def graph_ms(fn) -> float:
    """Device milliseconds of one ``fn()``: K10_REPS calls captured in one
    CUDA graph (after one call outside it), its replays timed by CUDA events,
    the median of 5 replays over K10_REPS. ``fn`` issues launch-only work."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(K10_REPS):
            fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / K10_REPS)
    return statistics.median(times)


def k10_bounds(n: int, count: int, n_f: int, n_u: int) -> dict:
    """(bound_ms, bound_by) of each K10 kernel at n params and ``count``
    history pairs: the control kernel at an iteration's end (d, gt, x, g,
    g_best read, s, y, x, g written; about ten operations an entry), the
    direction kernel (g, x, the count pairs and their rho read; d, xt and
    g_best written; 8 count n operations), the reset (x0 read, x, xt and gt
    written) and K3's value-and-grad (narrow_grad_bound)."""
    f32 = 4.0
    return {"lbfgs_control": bound([(10.0 * n, PEAK_FP32)], f32 * 9 * n),
            "lbfgs_direction": bound([(8.0 * count * n, PEAK_FP32)],
                                     f32 * ((2 * count + 2) * n + count + 3 * n)),
            "lbfgs_reset": bound([(0.0, PEAK_FP32)], f32 * 4 * n),
            "fused_value_and_grad": narrow_grad_bound(NARROW, n_f, n_u)}


def outer_epoch_bound(n: int, iters: int, history: int, n_f: int, n_u: int, post) -> tuple:
    """An L-BFGS outer epoch's least time on K10's runner: each of its
    ``iters`` iterations' value-and-grad, control and direction bounds (the
    direction's at the pairs held then, up to ``history``), plus the
    post-update's ``post`` (bound_ms, bound_by)."""
    total = post[0]
    for k in range(iters):
        b = k10_bounds(n, min(k, history), n_f, n_u)
        total += sum(b[name][0] for name in ("fused_value_and_grad", "lbfgs_control",
                                              "lbfgs_direction"))
    return total, "operations"


def k10_layout_checks(n: int, m: int) -> dict:
    """The direction kernel against its plain version on the descent guard
    (a seeded full history with an uphill gamma) at n params, and both
    kernels in lockstep with their plain versions on the streamed design at
    the scope's largest net (K10_WIDE params, a quartic valley, a history of
    m): every buffer bit-equal after every launch."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt.lbfgs import value_and_grad

    def same(b, twin, what):
        torch.cuda.synchronize()
        for name, got, want in zip(("si", "sf", "vec", "hist", "rho"), b.tensors(),
                                   twin.tensors()):
            check(torch.equal(got, want), f"K10 {what} differs from its plain version in {name}")

    guard = k_lbfgs.seeded_state(n, m, m, 9, seed=37, device="cuda", gamma=-1.0)
    twin = guard.clone()
    k_lbfgs.direction(guard)
    k_lbfgs.direction_reference(twin)
    same(guard, twin, "direction kernel on the descent guard")
    check(k_lbfgs.branches_taken(guard) == ["descent_guard"], "the descent guard was not taken")

    plan = k_lbfgs.cluster_plan(K10_WIDE, m)
    check(not plan.resident, f"the plan at {K10_WIDE} params is resident")
    rng = np.random.default_rng(K10_WIDE)
    a = torch.from_numpy(rng.uniform(0.5, 5.0, K10_WIDE).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.standard_normal(K10_WIDE).astype(np.float32)).cuda()
    vg = value_and_grad(lambda x: torch.sum(a * (x - c) ** 2 + 0.1 * (x - c) ** 4))
    b = k_lbfgs.Buffers.alloc(K10_WIDE, m, "cuda")
    k_lbfgs.reset(b, torch.zeros(K10_WIDE, device="cuda"), max_iters=8, gtol=0.0)
    steps = 0
    while not int(b.si[k_lbfgs.I_DONE]):
        f, g = vg(b.vec[k_lbfgs.XT].clone())
        b.sf[k_lbfgs.F_PHI_T] = f
        b.vec[k_lbfgs.GT].copy_(g)
        for which, kernel, plain in (("control", k_lbfgs.control, k_lbfgs.control_reference),
                                     ("direction", k_lbfgs.direction,
                                      k_lbfgs.direction_reference)):
            twin = b.clone()
            kernel(b)
            plain(twin)
            same(b, twin, f"{which} kernel (streamed, step {steps})")
        steps += 1
    return {"descent_guard": {"n": n, "count": m, "bit_equal": True},
            "streamed": {"n": K10_WIDE, "m": m, "plan": dataclasses.asdict(plan),
                         "steps": steps, "n_iters": int(b.si[k_lbfgs.I_K]),
                         "count_at_end": int(b.si[k_lbfgs.I_COUNT]),
                         "branches": k_lbfgs.branches_taken(b), "bit_equal": True},
            "plan": dataclasses.asdict(k_lbfgs.cluster_plan(n, m))}


def phase_k10(card: str) -> dict:
    """37: K10 from the JAX fixture's state (phase 13's): each kernel against
    its plain version, the solve against JAX's iterates, and its times
    beside the host loop's in this process."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as lb_mod
    from pinns_tpu_torch.train import trainer as tr

    problem, params, colloc, admm, _, fx = replay_state()
    exp, spec = problem.exp, problem.spec
    cfg = exp.optimizer.lbfgs
    check(not k_lbfgs.lbfgs_device_supported(exp, spec), "abgrall_admm outside K10's scope")
    x0, unravel = lb_mod.ravel_tree(params)
    n, off, rho = x0.numel(), k_lbfgs.net_offset(params), exp.loss.rho
    lcfg = k_fused.loss_config(exp)
    u_data = problem.targets["u"].contiguous()
    opts = dict(ftol=cfg.ftol, gtol=cfg.gtol, max_ls=cfg.max_ls)

    # -- K3's value-and-grad mode against autograd's gradient (phase 12's
    # criterion) and against its plain version, at x0
    p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
    g64, aux64 = plain_gradient(p64, params, colloc, admm, torch.float64)
    g_auto, aux = plain_gradient(problem, params, colloc, admm)
    grad, loss = torch.zeros_like(x0), torch.zeros(1, device="cuda")
    k_fused.fused_value_and_grad(spec, x0[off:], grad[off:], loss, problem.x_data, u_data,
                                 colloc, admm.z, admm.dual, rho=rho, **lcfg)
    f_plain, g_plain = k_fused.value_and_grad_reference(spec, x0[off:], problem.x_data, u_data,
                                                        colloc, admm.z, admm.dual, rho=rho, **lcfg)
    torch.cuda.synchronize()
    check(float(grad[:off].abs().max()) == 0.0, "the coefficients' gradient is not 0")
    vg_rows = {
        "vs_autograd": close_grad(host(grad[off:]), host(g_auto), spec.layers, host(g64)),
        "vs_plain": close_grad(host(grad[off:]), host(g_plain), spec.layers, host(g64)),
        "loss_vs_autograd": close("loss", float(loss), aux["loss"], scale=aux64["loss"]),
        "loss_vs_plain": close("loss", float(loss), float(f_plain), scale=aux64["loss"])}

    # -- the control and direction kernels against their plain versions, bit
    # for bit, step by step over the long solve (count up to m, the head
    # wrapped), K3's value-and-grad the evaluation; snapshots for the times
    b = k_lbfgs.Buffers.alloc(n, cfg.history, "cuda")
    twin = b.clone()
    k_lbfgs.reset(b, x0, max_iters=LONG_SOLVE, **opts)
    k_lbfgs.reset_reference(twin, x0, LONG_SOLVE, cfg.max_ls,
                            k_lbfgs.solve_constants(ftol=cfg.ftol, gtol=cfg.gtol))
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip((b.si, b.sf, b.vec), (twin.si, twin.sf, twin.vec))),
          "the reset kernel differs from its plain version")

    def evaluate():
        k_fused.fused_value_and_grad(
            spec, b.vec[k_lbfgs.XT, off:], b.vec[k_lbfgs.GT, off:],
            b.sf[k_lbfgs.F_PHI_T:k_lbfgs.F_PHI_T + 1], problem.x_data, u_data, colloc, admm.z,
            admm.dual, rho=rho, skip=b.si[:1], **lcfg)

    steps, snaps = 0, {}
    while not int(b.si[k_lbfgs.I_DONE]):
        evaluate()
        for which, kernel, plain in (("control", k_lbfgs.control, k_lbfgs.control_reference),
                                     ("direction", k_lbfgs.direction,
                                      k_lbfgs.direction_reference)):
            before = b.clone()
            twin = b.clone()
            kernel(b)
            plain(twin)
            torch.cuda.synchronize()
            for name, got, want in zip(("si", "sf", "vec", "hist", "rho"), b.tensors(),
                                       twin.tensors()):
                check(torch.equal(got, want),
                      f"K10 {which} kernel differs from its plain version in {name} "
                      f"at step {steps}")
            # the heaviest launch of each: the direction at the fullest
            # history, the control that ends an iteration and stores a pair
            full = int(before.si[k_lbfgs.I_COUNT])
            if which == "direction" and int(before.si[k_lbfgs.I_NEED_DIR]) \
                    and full >= snaps.get("direction_count", -1):
                snaps["direction"], snaps["direction_count"] = before, full
            if which == "control" and int(b.si[k_lbfgs.I_K]) > int(before.si[k_lbfgs.I_K]) \
                    and int(b.si[k_lbfgs.I_COUNT]) >= snaps.get("control_count", -1):
                snaps["control"], snaps["control_count"] = before, int(b.si[k_lbfgs.I_COUNT])
        steps += 1
    stepwise = k_lbfgs.result(b, k_lbfgs.read_head(b))
    branches = k_lbfgs.branches_taken(b)
    check("direction" in snaps and "control" in snaps, "the lockstep ended no iteration")
    check(k_lbfgs.cluster_plan(n, cfg.history).resident, "the fixture's plan is not resident")
    layouts = k10_layout_checks(n, cfg.history)

    # -- the solve as one launch of its WHILE node: JAX's iterates at 1, 2,
    # 5; the long solve's f in the band and at or below the 5-iteration f;
    # equal to the stepwise solve (x, f, g, n_iters, n_evals, the branches)
    # and to itself bit for bit
    solver = k_lbfgs.DeviceLBFGS(problem)
    solve = lambda k: solver.minimize(x0, off, colloc, admm, rho, max_iters=k,  # noqa: E731
                                      history=cfg.history, **opts)
    rows = {}
    x0_np = fx["x0"].astype(np.float64)
    for k in (1, 2, 5):
        res = solve(k)
        want = fx[f"x_{k}"].astype(np.float64)
        err = float(np.abs(host(res.x).astype(np.float64) - want).max())
        step = float(np.abs(want - x0_np).max())
        bnd = ITERATE_STEP_TOL * step + ITERATE_ULP_TOL * float(np.abs(want).max())
        check(err <= bnd, f"K10 x after {k} iterations: err {err} > {bnd}")
        check(res.n_iters == int(fx[f"n_iters_{k}"]),
              f"K10 n_iters {res.n_iters} != JAX {int(fx[f'n_iters_{k}'])}")
        rows[f"k{k}"] = {"max_abs_err": err, "bound": bnd, "jax_step": step,
                         "n_iters": res.n_iters, "n_evals": [res.n_evals, int(fx[f"n_evals_{k}"])],
                         "f": close("loss", float(res.f), float(fx[f"f_{k}"]))}
    f5 = float(res.f)
    long = solve(LONG_SOLVE)
    again = solve(LONG_SOLVE)
    check(torch.equal(long.x, again.x) and torch.equal(long.f, again.f)
          and (long.n_iters, long.n_evals) == (again.n_iters, again.n_evals),
          "two K10 solves differ")
    check(torch.equal(again.x, stepwise.x) and torch.equal(again.f, stepwise.f)
          and torch.equal(again.g, stepwise.g)
          and (again.n_iters, again.n_evals) == (stepwise.n_iters, stepwise.n_evals)
          and int(solver.bufs.si[k_lbfgs.I_BRANCHES]) == int(b.si[k_lbfgs.I_BRANCHES]),
          "the WHILE-node solve differs from the same steps launched one by one")
    f_jax, f = float(fx[f"f_{LONG_SOLVE}"]), float(long.f)
    band = (f_jax * (1 - LONG_SOLVE_BAND), f_jax * (1 + LONG_SOLVE_BAND))
    check(band[0] <= f <= band[1], f"K10 f after the long solve {f} outside {band}")
    check(f <= f5, f"K10's long solve ended at {f}, above the 5-iteration {f5}")

    # -- times: the long solve on K10 and on the host loop, in turns
    loss_fn = tr.make_loss_fn(problem)
    fun = lambda x: loss_fn(unravel(x), colloc, admm)[0]  # noqa: E731
    host_solve = lambda: lb_mod.lbfgs_minimize(  # noqa: E731
        fun, x0, max_iters=LONG_SOLVE, history=cfg.history, **opts)
    ref = host_solve()
    walls = {"k10": [], "host_loop": []}
    syncs = {}
    for _ in range(K10_TURNS):
        for name, fn in (("k10", lambda: solve(LONG_SOLVE)), ("host_loop", host_solve)):
            before = lb_mod.HOST_SYNCS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            syncs[name] = lb_mod.HOST_SYNCS - before
    check(syncs["k10"] == 1, f"{syncs['k10']} host syncs in a K10 solve")
    loop_before = (k_lbfgs.LOOP_LAUNCHES, k_lbfgs.LOOP_STEPS, k_lbfgs.STEPS_AFTER_END)
    solve(LONG_SOLVE)
    loop = [a - b for a, b in zip((k_lbfgs.LOOP_LAUNCHES, k_lbfgs.LOOP_STEPS,
                                   k_lbfgs.STEPS_AFTER_END), loop_before)]
    check(loop[0] == 1 and loop[2] < solver.steps
          and loop[1] == solver.steps * -(-long.n_evals // solver.steps),
          f"a solve's loop launches, steps and steps after its end {loop}, as the control "
          f"kernel counted them, for {long.n_evals} evaluations")
    iters = {"k10": long.n_iters, "host_loop": ref.n_iters}
    evals = {"k10": long.n_evals, "host_loop": ref.n_evals}
    profs = {"k10": device_profile(lambda: solve(LONG_SOLVE)),
             "host_loop": device_profile(host_solve)}
    per = lambda v, k: None if v is None else v / iters[k]  # noqa: E731
    times = {name: {
        "ms_per_iter": 1e3 * statistics.median(walls[name]) / iters[name],
        "wall_ms": [1e3 * w for w in walls[name]],
        "device_us_per_iter": per(profs[name]["device_us"], name),
        "launches_per_iter": per(profs[name]["kernels"], name),
        "syncs_per_iter": syncs[name] / iters[name], "n_iters": iters[name],
        "n_evals": evals[name], "evals_per_iter": evals[name] / iters[name],
        "idle_share": None if profs[name]["device_us"] is None else
        1.0 - profs[name]["device_us"] / (1e6 * statistics.median(walls[name])),
    } for name in walls}
    times["k10"]["by_kernel_us_per_iter"] = {
        kernel_name(key): v["us"] / iters["k10"] for key, v in profs["k10"]["by_name"].items()}
    times["k10"]["by_kernel_launches_per_iter"] = {
        kernel_name(key): v["launches"] / iters["k10"]
        for key, v in profs["k10"]["by_name"].items()}
    times["k10"]["capture_s"] = solver.capture_seconds
    # the solve's device span by CUDA events around its one launch (the
    # profiler's count of launches shows whether it saw every kernel of the
    # loop's body iterations)
    loop_graph = solver.solve_loop(float(np.float32(rho)))
    spans = []
    for _ in range(K10_TURNS):
        k_lbfgs.reset(solver.bufs, x0, max_iters=LONG_SOLVE, **opts)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loop_graph.launch()
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    span = statistics.median(spans)
    times["k10"].update(
        event_ms=spans, device_us_per_iter_by_events=1e3 * span / iters["k10"],
        idle_share_by_events=1.0 - span / (1e3 * statistics.median(walls["k10"])))
    times["k10"].update(steps_per_body=solver.steps, loop_launches_per_solve=loop[0],
                        steps_per_solve=loop[1], steps_after_end=loop[2])

    # -- each kernel's device time (a graph of K10_REPS launches, each after
    # the copies that restore its input, less a graph of the copies alone)
    # beside its plain version's and its bound, on the heaviest input the
    # lockstep met
    work = k_lbfgs.Buffers.alloc(n, cfg.history, "cuda")

    def restore(snap):
        for dst, src in zip(work.tensors(), snap.tensors()):
            dst.copy_(src)

    kern = {}
    for which, kernel, plain in (
            ("lbfgs_control", k_lbfgs._launch_control,
             k_lbfgs.control_reference),
            ("lbfgs_direction", lambda w: k_lbfgs._launch_direction(w, launch_only=True),
             k_lbfgs.direction_reference)):
        snap = snaps[which.split("_")[1]]
        ms = graph_ms(lambda: (restore(snap), kernel(work))) - graph_ms(lambda: restore(snap))
        kern[which] = (ms, event_ms(lambda: (restore(snap), plain(work))))
    # the direction kernel's streamed design on the same input (the plan's
    # resident design is in kern)
    streamed = k_lbfgs.ClusterPlan(False, -(-n // k_lbfgs.THREADS),
                                   k_lbfgs.direction_smem(n, cfg.history, False))
    snap = snaps["direction"]
    restore(snap)
    k_lbfgs._launch_direction(work, plan=streamed)  # sets the design up
    layouts["ms"] = {"direction_streamed": graph_ms(
        lambda: (restore(snap), k_lbfgs._launch_direction(work, True, streamed)))
        - graph_ms(lambda: restore(snap))}
    consts = k_lbfgs.solve_constants(ftol=cfg.ftol, gtol=cfg.gtol)
    kern["lbfgs_reset"] = (
        graph_ms(lambda: k_lbfgs._launch_reset(work, x0, LONG_SOLVE, cfg.max_ls, consts)),
        event_ms(lambda: k_lbfgs.reset_reference(work, x0, LONG_SOLVE, cfg.max_ls, consts)))
    partials = torch.empty((k_fused.step_plan(spec.layers, colloc.shape[0],
                                              problem.x_data.shape[0]).blocks,
                            spec.n_params + 1), device="cuda")
    vg = lambda launch_only=False: k_fused._value_and_grad_call(  # noqa: E731
        spec, x0[off:], grad[off:], loss, problem.x_data, u_data, colloc, admm.z, admm.dual,
        rho=rho, partials=partials, launch_only=launch_only, **lcfg)
    kern["fused_value_and_grad"] = (
        graph_ms(lambda: vg(launch_only=True)),
        event_ms(lambda: k_fused.value_and_grad_reference(
            spec, x0[off:], problem.x_data, u_data, colloc, admm.z, admm.dual, rho=rho,
            **lcfg)))
    vg_host_ms = event_ms(vg)
    bounds = k10_bounds(n, snaps["direction_count"], colloc.shape[0], problem.x_data.shape[0])
    emit(card, phase="k10", state=f"abgrall_admm_steps.npz step {REPLAY_STEP}",
         value_and_grad=vg_rows, lockstep={"steps": steps, "bit_equal": True,
                                           "branches": branches,
                                           "direction_count": snaps["direction_count"],
                                           "count_at_end": int(b.si[k_lbfgs.I_COUNT]),
                                           "head_at_end": int(b.si[k_lbfgs.I_HEAD])},
         rows=rows, long_solve={"max_iters": LONG_SOLVE, "n_iters": long.n_iters,
                                "n_evals": long.n_evals, "f": f, "f_jax": f_jax,
                                "jax_n_iters": int(fx[f"n_iters_{LONG_SOLVE}"]),
                                "jax_n_evals": int(fx[f"n_evals_{LONG_SOLVE}"]),
                                "band": list(band), "bitwise_repeatable": True,
                                "host_loop_f": float(ref.f)},
         times=times, kernels={k: {"ms": v[0], "plain_ms": v[1], "bound_ms": bounds[k][0],
                                   "bound_by": bounds[k][1]} for k, v in kern.items()},
         layouts=layouts,
         value_and_grad_host_call_ms=vg_host_ms,
         clock="host for the solves, the profiler for their device time, events over "
               "captured graphs for the kernels, events for the plain versions")
    return {"kernels": kern, "bounds": bounds, "times": times,
            "max_abs_err": vg_rows["vs_plain"]["max_abs_err"]}


# -- 38-39: slice 2b-iii, part 1 (K7b's entropy mode, the Euler L-BFGS branch) --

ENTROPY_WEIGHT = 0.1  # phase 38's entropy-weighted steps
ENTROPY_PRESETS = ("twosin_weak", "euler_weak_fast")
TAIL_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "euler_weak_tail.npz")
TAIL_PRESET = "euler_weak_tail"
K10_EULER_N = 162_413  # the Euler trunk with two paths and the two coefficients
# evaluation steps of the direction / control lockstep at K10_EULER_N (more
# until an iteration has ended, at most four times as many)
TAIL_LOCKSTEP = 12
TAIL_TIMED_ITERS = 50  # the capped outer epoch timed beside the host loop
TAIL_TURNS = 3  # alternating outer epochs a side for those times
TAIL_CLI = {"members": 2, "outer": 2, "max_iters": 20}  # the CLI tail from phase 35's members


def k7b_entropy_plain(kind: str, y, yx, hxe, hte, coeffs):
    """(r, ent) of the plain quadrature with the entropy (gamma - 1 is
    coeffs[0] for Euler)."""
    from pinns_tpu_torch.ops import weakform as twf

    if kind == "burgers":
        return twf.burgers_quadrature_reference(y, yx, hxe, hte, coeffs[0], coeffs[1], K7B_QUAD,
                                                True)
    gamma = float(coeffs[0].detach()) + 1.0
    rs, ent = twf.euler_quadrature_reference(y, yx, hxe, hte, gamma, coeffs[1], K7B_QUAD, True)
    return torch.cat(rs, dim=1), ent


def k7b_entropy_bytes(kind: str, viscous: bool, n: int) -> dict:
    """k7b_bytes with the entropy mode's extra traffic (e and relu(e)^2
    written, g_ent and e read back: 8 bytes a cell each way) and operations
    (per edge row: Burgers about 6 FLOP more, Euler about 20 with its two
    logs, counted as operations of the float32 rate)."""
    fields = 1 if kind == "burgers" else 3
    rows = n * 4 * K7B_QUAD
    vals = 4 * rows * fields * (2 if viscous else 1)
    per_row = (8 + 6) if kind == "burgers" else (30 + 20)
    return {"forward": bound([(per_row * rows, PEAK_FP32)],
                             vals + 8 * n + 8 + 4 * n * fields + 8 * n),
            "backward": bound([(2.0 * per_row * rows, PEAK_FP32)],
                              4 * n * fields + 8 * n + 2 * vals + 8 * n + 16)}


def phase_k7b_entropy(card: str) -> dict:
    """38: K7b's entropy mode against its plain version on the card: r,
    relu(e)^2 and the backward with both cotangents (g_y, g_yx, the
    coefficients' gradient) by the float64 criterion (autograd through the
    plain quadrature with want_entropy for the backward), Burgers and Euler,
    viscous and inviscid, N 1,000 and 65,536; r equal bit for bit to the
    mode without the entropy; two calls of each bit-equal; times by events
    beside k7b_entropy_bytes. Then one entropy-weighted step of each of
    twosin_weak and euler_weak_fast at full width from its fixture state:
    the loss and every gradient leaf against the plain path on the card
    and against float64, the entropy mode's launches counted."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.models.mlp import MLPSpec
    from pinns_tpu_torch.ops.kernels import weakform as k7b
    from pinns_tpu_torch.train import trainer as tr

    spec = MLPSpec(layers=(2, 4, 1), lb=LB, ub=UB)
    hx, ht = 0.02 * (UB[0] - LB[0]), 0.02 * (UB[1] - LB[1])
    out = {"kernels": {}, "times": {}, "steps": {}}
    for kind, viscous, n in K7B_SHAPES:
        c, y, yx, coeffs, g_r = k7b_inputs(kind, viscous, n)
        g_ent = torch.from_numpy(np.random.default_rng(n + 9).standard_normal((n, 1))
                                 .astype(np.float32)).cuda()
        gamma = float(coeffs[0]) + 1.0 if kind == "euler" else 1.4
        _, hxe, hte = k7b.edge_points(spec, c, hx, ht, K7B_QUAD)
        fwd = lambda: k7b.flux_forward(kind, y, yx, hxe, hte, coeffs, K7B_QUAD,  # noqa: E731
                                       True, gamma)
        r, ent, e = fwd()
        again = fwd()
        r0 = k7b.flux_forward(kind, y, yx, hxe, hte, coeffs, K7B_QUAD)
        bwd = lambda: k7b.flux_backward(kind, g_r, y, yx, hxe, hte, coeffs,  # noqa: E731
                                        K7B_QUAD, g_ent, e, gamma)
        gy, gyx, gc = bwd()
        gagain = bwd()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((r, ent, e), again)),
              f"K7b entropy forward not repeatable at {kind}, N {n}")
        check(all(a is b or torch.equal(a, b) for a, b in zip((gy, gyx, gc), gagain)),
              f"K7b entropy backward not repeatable at {kind}, N {n}")
        check(torch.equal(r, r0), f"K7b r moves with the entropy mode at {kind}, N {n}")
        ref = {}
        for dtype in (torch.float32, torch.float64):
            args = [None if a is None else a.to(dtype).clone().requires_grad_(True)
                    for a in (y, yx, coeffs)]
            pr, pent = k7b_entropy_plain(kind, args[0], args[1], hxe.to(dtype), hte.to(dtype),
                                         args[2])
            wrt = [a for a in args if a is not None]
            grads = torch.autograd.grad(
                torch.sum(pr * g_r.to(dtype)) + torch.sum(pent * g_ent.to(dtype)), wrt,
                allow_unused=True)
            ref[dtype] = [pr, pent] + [torch.zeros_like(a) if g is None else g
                                       for g, a in zip(grads, wrt)]
        names = ["r", "ent", "g_y"] + (["g_yx"] if viscous else []) + ["g_coeffs"]
        got = [r, ent, gy] + ([gyx] if viscous else []) + [gc]
        rows = {name: close_or_f64(name, host(g), host(p), host(x))
                for name, g, p, x in zip(names, got, ref[torch.float32], ref[torch.float64])}
        active = float((ent > 0).float().mean())
        check(0.0 < active, f"K7b entropy inactive everywhere at {kind}, N {n}")
        with torch.no_grad():
            t_fwd = event_ms(fwd)
            t_fwd_plain = event_ms(lambda: k7b_entropy_plain(kind, y, yx, hxe, hte, coeffs))
            t_bwd = event_ms(bwd)
        args = [None if a is None else a.clone().requires_grad_(True) for a in (y, yx, coeffs)]
        wrt = [a for a in args if a is not None]

        def plain_backward():
            pr, pent = k7b_entropy_plain(kind, args[0], args[1], hxe, hte, args[2])
            return torch.autograd.grad(torch.sum(pr * g_r) + torch.sum(pent * g_ent), wrt,
                                       allow_unused=True)

        t_bwd_plain = event_ms(plain_backward)
        b = k7b_entropy_bytes(kind, viscous, n)
        key = (kind, viscous, n)
        out["kernels"][key] = (max(rows[k]["max_abs_err_vs_plain"] for k in ("r", "ent")),
                               max(v["max_abs_err_vs_plain"] for k, v in rows.items()
                                   if k not in ("r", "ent")))
        out["times"][key] = {"forward": (t_fwd, t_fwd_plain, b["forward"]),
                             "backward": (t_bwd, t_bwd_plain, b["backward"])}
        emit(card, phase="k7b-entropy", kind=kind, viscous=viscous, n=n, quad=K7B_QUAD,
             active_share=active, bit_equal_across_calls=True, r_equal_without_entropy=True,
             criterion="f64_oracle", outputs=rows, forward_ms=t_fwd,
             forward_plain_ms=t_fwd_plain, forward_bound_ms=b["forward"][0],
             backward_ms=t_bwd, backward_plain_ms=t_bwd_plain,
             backward_bound_ms=b["backward"][0], reps=REPS, clock="cuda_events")

    wfx, pfx = weak_fixture(), path_fixture()
    for preset in ENTROPY_PRESETS:
        exp = override(get_preset(preset), {"loss.entropy_weight": ENTROPY_WEIGHT})
        problem = tr.build_problem(exp, "cuda")
        p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
        if preset == "twosin_weak":
            state = weak_state(wfx, preset, problem.device)
            sizes = None
            layers = problem.spec.layers
        else:
            net, sizes = path_fixture_net(pfx, pfx["band_params"], problem.spec)
            from pinns_tpu_torch.interop import params_from_jax

            params = {"net": params_from_jax(net, problem.device),
                      "coeffs": {"lambda1": torch.ones(1, device="cuda"),
                                 "lambda2": torch.full((1,), 1e-3, device="cuda")}}
            state = tr.TrainState(params=params, opt_state=None, admm=None,
                                  colloc=torch.from_numpy(pfx["colloc_0"]).cuda(), key=0,
                                  epoch=0)
            layers = None
        reset_counts()
        with PlainCalls() as plain:
            loss, grad, gco = weak_gradient(problem, state.params, state.colloc, plain=False)
            torch.cuda.synchronize()
        launches = kernel_counts()
        check(plain.calls == 0 and launches["weakform_flux_entropy"] == 1
              and launches["weakform_flux_entropy_backward"] == 1,
              f"{preset}: the entropy-weighted loss's launches {launches}, "
              f"{plain.calls} plain calls")
        ploss, pgrad, _ = weak_gradient(problem, state.params, state.colloc, plain=True)
        eloss, egrad, _ = weak_gradient(p64, state.params, state.colloc, plain=True,
                                        dtype=torch.float64)
        no_ent = weak_gradient(tr.build_problem(get_preset(preset), "cuda"), state.params,
                               state.colloc, plain=False)[0]
        check(loss != no_ent, f"{preset}: the entropy weight leaves the loss as it was")
        rows = {"loss_vs_plain": close("loss", loss, ploss, scale=abs(eloss)),
                "loss_vs_f64": close("loss", loss, eloss, scale=abs(eloss)),
                "grad": close_grad(grad, pgrad, layers, egrad, sizes=sizes)}
        out["steps"][preset] = {"launches": launches, "grad_err": rows["grad"]["max_abs_err"]}
        emit(card, phase="k7b-entropy", what="weighted_step", preset=preset,
             entropy_weight=ENTROPY_WEIGHT, loss=loss, loss_without_entropy=no_ent, rows=rows,
             launches={k: v for k, v in launches.items() if v}, plain_calls=plain.calls)
    return out


def tail_fixture() -> dict:
    with np.load(TAIL_FIXTURE, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def tail_state(problem):
    """The tail fixture's start on the card: (params tree, colloc), the
    params euler_weak.npz's band_params with the fixture's coefficients."""
    from pinns_tpu_torch.interop import params_from_jax

    fx, pfx = tail_fixture(), path_fixture()
    net, _ = path_fixture_net(pfx, pfx["band_params"], problem.spec)
    dev = problem.device
    params = {"net": params_from_jax(net, dev),
              "coeffs": {"lambda1": torch.from_numpy(fx["coeffs"][0:1]).to(dev),
                         "lambda2": torch.from_numpy(fx["coeffs"][1:2]).to(dev)}}
    return params, torch.from_numpy(fx["colloc"]).to(dev), fx


def k10_euler_lockstep(n: int, m: int) -> dict:
    """The control and direction kernels against their plain versions, bit
    for bit after every launch, at n params from a seeded full history of m
    pairs (the head wraps as pairs are stored), a quartic valley the
    evaluation (its value and gradient at the seeded x replace the seeded
    ones, so that the searches end as a solve's do); TAIL_LOCKSTEP
    evaluation steps, more until an iteration has stored a pair. Returns
    the snapshots the times start from: the direction at the full history,
    the control that stores a pair."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt.lbfgs import value_and_grad

    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.uniform(0.5, 5.0, n).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    vg = value_and_grad(lambda x: torch.sum(a * (x - c) ** 2 + 0.1 * (x - c) ** 4))
    b = k_lbfgs.seeded_state(n, m, m, 9, seed=43, device="cuda")
    f, g = vg(b.vec[k_lbfgs.X].clone())
    b.sf[k_lbfgs.F_F] = f
    b.vec[k_lbfgs.G].copy_(g)
    snaps, launches = {}, {"control": 0, "direction": 0}
    for step in range(4 * TAIL_LOCKSTEP):
        for which, kernel, plain in (("direction", k_lbfgs.direction,
                                      k_lbfgs.direction_reference),
                                     ("control", k_lbfgs.control, k_lbfgs.control_reference)):
            if which == "control":
                f, g = vg(b.vec[k_lbfgs.XT].clone())
                b.sf[k_lbfgs.F_PHI_T] = f
                b.vec[k_lbfgs.GT].copy_(g)
            before, twin = b.clone(), b.clone()
            kernel(b)
            plain(twin)
            torch.cuda.synchronize()
            for name, got, want in zip(("si", "sf", "vec", "hist", "rho"), b.tensors(),
                                       twin.tensors()):
                check(torch.equal(got, want), f"K10 {which} kernel differs from its plain "
                      f"version in {name} at n {n}, step {step}")
            launches[which] += 1
            if which == "direction" and int(before.si[k_lbfgs.I_NEED_DIR]):
                snaps.setdefault("direction", before)
            if which == "control" and (int(b.si[k_lbfgs.I_BRANCHES])
                                       & k_lbfgs.BRANCHES["stored"]):
                snaps.setdefault("control", before)
        if int(b.si[k_lbfgs.I_DONE]) or (step + 1 >= TAIL_LOCKSTEP and len(snaps) == 2):
            break
    check(len(snaps) == 2, f"the lockstep at the Euler n met {sorted(snaps)} only")
    return {"steps": step + 1, "launches": launches, "branches": k_lbfgs.branches_taken(b),
            "count_at_end": int(b.si[k_lbfgs.I_COUNT]), "head_at_end": int(b.si[k_lbfgs.I_HEAD]),
            "n_iters": int(b.si[k_lbfgs.I_K]), "snaps": snaps}


def k10_kernel_ms(snap, which: str) -> tuple:
    """(kernel ms, plain ms) of the direction or control kernel from a
    snapshot: a graph of K10_REPS launches, each after the copies that
    restore what it reads and writes (si, sf, vec, rho: the history it reads
    is rewritten with the same values), less a graph of the copies alone;
    the plain version by events over 3 calls."""
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

    work = snap.clone()

    def restore():
        for dst, src in ((work.si, snap.si), (work.sf, snap.sf), (work.vec, snap.vec),
                         (work.rho, snap.rho)):
            dst.copy_(src)

    launch = ((lambda: k_lbfgs._launch_direction(work, launch_only=True))
              if which == "direction" else (lambda: k_lbfgs._launch_control(work)))
    ms = graph_ms(lambda: (restore(), launch())) - graph_ms(restore)
    plain = (k_lbfgs.direction_reference if which == "direction"
             else k_lbfgs.control_reference)
    times = []
    for _ in range(3):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(work)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return ms, statistics.median(times)


def timed_outer(step, state, reps: int) -> dict:
    """Wall ms of ``reps`` calls of an L-BFGS outer epoch ``step`` from the
    same state, each ending in a sync, and the host syncs of the last."""
    from pinns_tpu_torch.opt import lbfgs as lb_mod

    walls, iters = [], None
    for _ in range(reps):
        before = lb_mod.HOST_SYNCS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state)
        iters = int(float(m["lbfgs_iters"]))
        walls.append(1e3 * (time.perf_counter() - t0))
        syncs = lb_mod.HOST_SYNCS - before
    return {"wall_ms": walls, "n_iters": iters, "syncs": syncs}


def phase_euler_tail(card: str, members, member_epoch: int) -> dict:
    """39: the Euler L-BFGS branch on the card. K10's direction and control
    kernels against their plain versions bit for bit at the Euler trunk's
    n = 162,413 and a full history of 50 pairs, each timed beside its bound;
    the outer epoch of euler_weak_tail from the JAX fixture's state at
    max_iters 1, 2 and 5, on K10 (AutogradLBFGS, the trainer's solver here)
    and on the host loop, against JAX's n_iters, n_evals and f; a capped
    outer epoch of TAIL_TIMED_ITERS iterations timed on K10 (the evaluation
    captured into the solve's WHILE node, one launch and one read a solve;
    and the same solver host-stepped, the flag read every 16 steps, bit for
    bit the same at max_iters 1, 2 and 5) and on the host loop in turns, with
    each side's host syncs and device time (:func:`device_fields`: CUDA events
    around the captured loop, the profiler for the other sides); then this
    slice's main path: ``train --preset euler_weak_tail
    --resume`` from two of phase 35's euler_weak_fast members for
    TAIL_CLI['outer'] outer epochs, and ``export --select rank`` of the two
    tails against the members, no plain call, every solve on K10."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves
    from pinns_tpu_torch.opt import lbfgs as lb_mod
    from pinns_tpu_torch.train import trainer as tr

    exp = get_preset(TAIL_PRESET)
    cfg = exp.optimizer.lbfgs
    problem = tr.build_problem(exp, "cuda")
    check(k_lbfgs.lbfgs_device_supported(exp, problem.spec) != [],
          "euler_weak_tail inside K3's scope")
    # -- the kernels at the Euler trunk's n
    plan = k_lbfgs.cluster_plan(K10_EULER_N, cfg.history)
    check(not plan.resident, f"the plan at n {K10_EULER_N} is resident")
    lock = k10_euler_lockstep(K10_EULER_N, cfg.history)
    kern = {which: k10_kernel_ms(lock["snaps"][which], which)
            for which in ("direction", "control") if which in lock["snaps"]}
    bounds = k10_bounds(K10_EULER_N, cfg.history, 1, 1)

    # -- the fixture's outer epochs against JAX
    params, colloc, fx = tail_state(problem)
    x0, unravel = lb_mod.ravel_tree(params)
    check(x0.numel() == K10_EULER_N, f"the Euler tail's n {x0.numel()}")
    loss_fn = tr.make_loss_fn(problem)
    fun = lambda x: loss_fn(unravel(x), colloc, None)[0]  # noqa: E731
    f0 = float(fun(x0).detach())
    rows = {}
    opts = dict(history=cfg.history, ftol=cfg.ftol, gtol=cfg.gtol, max_ls=cfg.max_ls)
    solver = k_lbfgs.AutogradLBFGS()
    stepped = k_lbfgs.AutogradLBFGS(captured=False)
    for k in (int(i) for i in fx["iters"]):
        for name, solve in (("k10", lambda: solver.minimize(fun, x0, max_iters=k, **opts)),
                            ("k10_host_stepped",
                             lambda: stepped.minimize(fun, x0, max_iters=k, **opts)),
                            ("host_loop", lambda: lb_mod.lbfgs_minimize(fun, x0, max_iters=k,
                                                                         **opts))):
            syncs = lb_mod.HOST_SYNCS
            res = solve()
            syncs = lb_mod.HOST_SYNCS - syncs
            if name == "k10":
                captured = res
                check(syncs == 1 and solver.loop.loop is not None,
                      f"the captured solve at max_iters {k}: {syncs} host syncs")
            elif name == "k10_host_stepped":
                check(torch.equal(res.x, captured.x) and torch.equal(res.f, captured.f)
                      and torch.equal(res.g, captured.g)
                      and (res.n_iters, res.n_evals) == (captured.n_iters, captured.n_evals)
                      and int(stepped.bufs.si[k_lbfgs.I_BRANCHES])
                      == int(solver.bufs.si[k_lbfgs.I_BRANCHES]),
                      f"the captured solve at max_iters {k} differs from the host-stepped one")
            got = (res.n_iters, res.n_evals)
            want = (int(fx[f"n_iters_{k}"]), int(fx[f"n_evals_{k}"]))
            check(got == want, f"{name} at max_iters {k}: (n_iters, n_evals) {got} != JAX {want}")
            leaves = [host(v).astype(np.float64) for v in net_leaves(unravel(res.x)["net"])]
            rows[f"{name}_k{k}"] = {
                "n_iters": res.n_iters, "n_evals": res.n_evals, "host_syncs": syncs,
                "f": close("loss", float(res.f), float(fx[f"f_{k}"])),
                "leaf_sums": measure("leaf_sums", np.asarray(
                    [(v.sum(), (v * v).sum()) for v in leaves]), fx[f"sums_{k}"])}
    check(abs(f0 - float(fx["loss_0"])) <= 1e-4 * abs(float(fx["loss_0"])),
          f"the tail fixture's loss {f0} vs JAX {float(fx['loss_0'])}")

    # -- times: a capped outer epoch on K10 (captured, and host-stepped with
    # the flag read every 16 steps) and on the host loop
    capped = tr.build_problem(override(exp, {"optimizer.lbfgs.max_iters": TAIL_TIMED_ITERS}),
                              "cuda")
    state = tr.TrainState(params=params, opt_state=None, admm=None, colloc=colloc, key=0,
                          epoch=int(fx["epoch"]))
    steps = {"k10": tr.make_lbfgs_step(capped), "host_loop": tr.make_lbfgs_step(capped,
                                                                               host_loop=True)}
    check(isinstance(steps["k10"].solver, k_lbfgs.AutogradLBFGS)
          and steps["host_loop"].solver is None, "the outer epochs' solvers")
    steps["k10_host_stepped"] = tr.make_lbfgs_step(capped)
    steps["k10_host_stepped"].solver.captured = False
    for fn in steps.values():  # warm-up
        fn(state)
    walls = {name: [] for name in steps}
    for _ in range(TAIL_TURNS):
        for name, fn in steps.items():
            r = timed_outer(fn, state, 1)
            walls[name] += r["wall_ms"]
            walls[name + "_iters"], walls[name + "_syncs"] = r["n_iters"], r["syncs"]
    times = {}
    for name, fn in steps.items():
        it = walls[name + "_iters"]
        wall = statistics.median(walls[name])
        times[name] = {
            "ms_per_iter": wall / it, "wall_ms": walls[name], "n_iters": it,
            "syncs_per_iter": walls[name + "_syncs"] / it,
            **device_fields(lambda: fn(state), it, wall,
                            captured=getattr(fn.solver, "captured", False))}
    check(walls["k10_iters"] == walls["host_loop_iters"] == walls["k10_host_stepped_iters"],
          f"the capped outer epochs took {walls['k10_iters']}, {walls['host_loop_iters']} and "
          f"{walls['k10_host_stepped_iters']} iterations")
    check(walls["k10_syncs"] == 1, f"{walls['k10_syncs']} host syncs in a captured outer epoch")
    times["k10"]["steps_per_body"] = steps["k10"].solver.steps
    times["k10"]["capture_s"] = steps["k10"].solver.capture_seconds[-1]

    # -- the main path: the CLI tail from phase 35's members, then the pick
    tmp = os.path.dirname(members[0])
    tails = []
    reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        summaries = []
        for i, member in enumerate(members[:TAIL_CLI["members"]]):
            out_dir = os.path.join(tmp, f"tail_m{i}")
            summaries.append(cli_json([
                "train", "--preset", TAIL_PRESET, "--resume", member, "--out-dir", out_dir,
                "--set", f"optimizer.switch_epoch={member_epoch}",
                "--set", f"train.epochs={member_epoch + TAIL_CLI['outer']}",
                "--set", f"optimizer.lbfgs.max_iters={TAIL_CLI['max_iters']}",
                "--device", "cuda"]))
            tails.append(os.path.join(out_dir, f"{TAIL_PRESET}_final.ckpt"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = kernel_counts()
        sel_art = os.path.join(tmp, "tail_selected")
        anchors = members[:TAIL_CLI["members"]]
        rc, sel = cli_lines(["export", "--preset", TAIL_PRESET, "--checkpoint", *tails,
                             "--select", "rank", "--anchor", *anchors, "--out", sel_art,
                             "--device", "cuda"])
        t2 = time.perf_counter()
    solves = TAIL_CLI["members"] * TAIL_CLI["outer"]
    check(plain.calls == 0, f"{plain.calls} calls of a plain version on the tail's path")
    check(launches["lbfgs_solves"] == solves and launches["lbfgs_reset"] == solves
          and launches["lbfgs_control"] > 0 and launches["lbfgs_direction"] > 0
          and launches["lbfgs_loop_launches"] == launches["lbfgs_host_syncs"] == solves
          and launches["fused_value_and_grad"] == 0,
          f"the tail's K10 launches {launches}")
    check(all(launches[k] > 0 for k in ("weakform_edge_points", "weakform_flux",
                                         "weakform_flux_backward", "taylor1", "taylor1_backward",
                                         "mlp_forward", "mlp_backward")),
          f"the tail's loss launches {launches}")
    check(all(summary["epochs"] == member_epoch + TAIL_CLI["outer"] and all(
        math.isfinite(summary[f"rel_l2_{f}"]) for f in EULER_FIELDS) for summary in summaries),
        f"the tails' summaries {summaries}")
    check(rc == 0 and sel[-1]["by"] == "rank" and 0 <= sel[-1]["selected"] < len(tails),
          f"export --select rank of the tails: {sel}")
    with open(os.path.join(sel_art, "meta.json")) as f:
        selection = json.load(f)["selection"]
    check(selection["anchor"] == anchors, f"meta['selection'] {selection}")
    emit(card, phase="euler-tail", n=K10_EULER_N, history=cfg.history,
         plan=dataclasses.asdict(plan),
         lockstep={k: v for k, v in lock.items() if k != "snaps"},
         kernels={which: {"ms": v[0], "plain_ms": v[1],
                          "bound_ms": bounds[f"lbfgs_{which}"][0],
                          "bound_by": bounds[f"lbfgs_{which}"][1]} for which, v in kern.items()},
         fixture={"f_0": f0, "jax_loss_0": float(fx["loss_0"]), **rows},
         outer_epoch={"max_iters": TAIL_TIMED_ITERS, **times},
         cli={"members": TAIL_CLI["members"], "member_epoch": member_epoch,
              "outer": TAIL_CLI["outer"], "max_iters": TAIL_CLI["max_iters"],
              "rel_l2": [{f: s[f"rel_l2_{f}"] for f in EULER_FIELDS} for s in summaries],
              "selected": sel[-1]["selected"], "train_s": t1 - t0, "select_s": t2 - t1},
         launches={k: v for k, v in launches.items() if v}, plain_calls=plain.calls)
    return {"kernels": kern, "bounds": bounds, "launches": launches, "times": times}


# -- 40: K10's outer epochs as chunks (LBFGSChunk, K3's post-update mode) --------

# the post-update mode against its plain version: (rtol, atol as a multiple
# of max|plain| or of the scale of the terms a difference cancels), else the
# float64 criterion (hold_post)
POST_TOL = {"z": (1e-5, 1e-5), "dual": (1e-5, 1e-5), "admm_misfit": (1e-5, 1e-5),
            "data_term": (1e-5, 1e-5)}
CHUNK_LENGTHS = (1, 3, 10)
CHUNK_MAX_ITERS = 50  # the iterations of phase 40's bit-for-bit chunks
CHUNK_TURNS = 3  # alternating chunks a side (the runner, the per-outer-epoch step)


def post_update_bound(layers, n_f: int, n_u: int):
    """K3's post-update mode: the tail's Taylor-2 forward at the new points
    and the value stream's forward at the data points; the params, the dual,
    the data points and their targets read once, the points, z, dual and the
    metrics row written once (with the solve's f and iterations read)."""
    ops = taylor2_ops(layers, n_f) + [(2.0 * sum(_macs(layers)) * n_u, PEAK_FP32)]
    return bound(ops, 4 * n_params(layers) + 20 * n_f + 12 * n_u + 4 * 9)


def hold_post(name: str, got, plain, exact, scale=None) -> dict:
    """A post-update output against its plain version within POST_TOL[name]
    (atol relative to ``scale``, default max|plain|), or else by the float64
    criterion (compare_f64's: its error against the float64 twin at most
    F64_FACTOR times the plain version's plus 1e-6 max|exact|); raises if
    neither holds."""
    rtol, atol_rel = POST_TOL[name]
    got, plain, exact = (np.asarray(a, np.float64).ravel() for a in (got, plain, exact))
    check(bool(np.isfinite(got).all()), f"post-update {name}: non-finite values")
    err = np.abs(got - plain)
    atol = atol_rel * (float(np.abs(plain).max()) if scale is None else scale)
    e_k, e_p = float(np.abs(got - exact).max()), float(np.abs(plain - exact).max())
    row = {"max_abs_err": float(err.max()), "rtol": rtol, "atol": atol,
           "tol_ok": bool((err <= atol + rtol * np.abs(plain)).all()),
           "err_vs_f64": e_k, "plain_err_vs_f64": e_p,
           "f64_ok": e_k <= F64_FACTOR * e_p + 1e-6 * float(np.abs(exact).max())}
    check(row["tol_ok"] or row["f64_ok"], f"post-update {name}: {row}")
    return row


class SolveClock:
    """While entered, every K10 solve's launch (SolveLoop.launch, the
    runner's and the per-outer-epoch step's) is bracketed by synchronizes
    and their host-clock milliseconds summed in ``ms``."""

    def __enter__(self):
        from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

        self.cls, self.saved, self.ms = k_lbfgs.SolveLoop, k_lbfgs.SolveLoop.launch, 0.0
        clock = self

        def timed(loop):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return clock.saved(loop)
            finally:
                torch.cuda.synchronize()
                clock.ms += 1e3 * (time.perf_counter() - t0)
        self.cls.launch = timed
        return self

    def __exit__(self, *exc):
        self.cls.launch = self.saved


class LoopSpans:
    """While entered, every K10 solve loop's launch (SolveLoop.launch) is
    bracketed by CUDA events on the current stream, with no synchronize;
    :meth:`ms` sums their elapsed milliseconds: the loops' device span
    (torch.profiler records only a loop's first body iteration)."""

    def __enter__(self):
        from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

        self.cls, self.saved, self.events = k_lbfgs.SolveLoop, k_lbfgs.SolveLoop.launch, []
        spans = self

        def bracketed(loop):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            try:
                return spans.saved(loop)
            finally:
                end.record()
                spans.events.append((start, end))
        self.cls.launch = bracketed
        return self

    def __exit__(self, *exc):
        self.cls.launch = self.saved

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in self.events)


def device_fields(fn, it: int, wall_ms: float, captured: bool) -> dict:
    """The device time and idle share of one more call ``fn()`` of ``it``
    L-BFGS iterations. A captured solver's (its solves SolveLoop launches):
    the loops' span by CUDA events (:class:`LoopSpans`) over the same call's
    host-clock wall, the time outside the loops counted idle; launches not
    measured. Another's: torch.profiler's device time and launches over
    ``wall_ms``."""
    if captured:
        with LoopSpans() as spans:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        loop_ms = spans.ms()
        return {"device_us_per_iter": 1e3 * loop_ms / it, "launches_per_iter": None,
                "idle_share": 1.0 - loop_ms / wall, "loops": len(spans.events),
                "device_clock": "CUDA events around each solve loop's launch"}
    prof = device_profile(fn)
    us = prof["device_us"]
    return {"device_us_per_iter": None if us is None else us / it,
            "launches_per_iter": None if prof["kernels"] is None else prof["kernels"] / it,
            "idle_share": None if us is None else 1.0 - us / (1e3 * wall_ms),
            "device_clock": "torch.profiler"}


def phase_lbfgs_chunk(card: str, adam: dict) -> dict:
    """40: K10's outer epochs as chunks (LBFGSChunk). K3's post-update mode
    against its plain version at the fixture's state; chunks of
    CHUNK_LENGTHS outer epochs, drawn and fed, bit for bit against the same
    kernels driven one outer epoch a host call, one launch of the solve's
    WHILE node an outer epoch and no read of the device inside a chunk; one outer epoch against
    JAX's iterate at 5 iterations; the times of an outer epoch on the runner
    and on the per-outer-epoch step from phase 9's state, in turns."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.data.sampling import philox_uniform
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import fused_step as k_fused
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as lb_mod
    from pinns_tpu_torch.opt.adam import tree_leaves
    from pinns_tpu_torch.train import trainer as tr

    problem, params, colloc, admm, _, fx = replay_state()
    exp, spec = problem.exp, problem.spec
    check(not k_lbfgs.lbfgs_chunk_supported(exp, spec), "abgrall_admm outside the chunk scope")
    lcfg = k_fused.loss_config(exp)
    x0, _ = lb_mod.ravel_tree(params)
    off, rho = k_lbfgs.net_offset(params), exp.loss.rho
    u_data = problem.targets["u"].contiguous()
    n_f, n_u = colloc.shape[0], problem.x_data.shape[0]

    # -- (a) the post-update mode against its plain version, row 1 of 3
    rows_n, seed, epoch = 3, 1234, 7
    sched = torch.from_numpy(k_fused.chunk_schedule(0, epoch, rows_n)).cuda()
    table = k_fused.member_table([seed], [rho], n_f, "cuda")
    iters_in = torch.tensor([61], dtype=torch.int32, device="cuda")

    def bufs(dtype=torch.float32):
        return {"colloc": colloc.to(dtype).clone(), "z": admm.z.to(dtype).clone(),
                "dual": admm.dual.to(dtype).clone(), "f_in": torch.tensor([0.5], dtype=dtype,
                                                                          device="cuda"),
                "metrics": torch.zeros(rows_n, 7, dtype=dtype, device="cuda"),
                "cursor": torch.ones(1, dtype=torch.int32, device="cuda")}

    def post(fn, b, sp=spec, p=x0[off:], x=problem.x_data, u=u_data, **kw):
        fn(sp, p, x, u, b["colloc"], b["z"], b["dual"], b["metrics"], b["cursor"], sched, table,
           b["f_in"], iters_in, kind=lcfg["kind"], lam1=lcfg["lam1"], lam2=lcfg["lam2"], **kw)

    kb, pb, eb = bufs(), bufs(), bufs(torch.float64)
    before = kernel_counts()["fused_post_update"]
    post(k_fused.fused_post_update, kb)
    post(k_fused.post_update_reference, pb)
    drawn = philox_uniform(seed, epoch + 2, n_f, spec.lb, spec.ub, torch.float32, "cuda")
    eb["colloc"] = drawn.double()
    post(k_fused.post_update_reference, eb, sp=dataclasses.replace(spec, dtype=torch.float64),
         p=x0[off:].double(), x=problem.x_data.double(), u=u_data.double(), fixed=True)
    torch.cuda.synchronize()
    check(kernel_counts()["fused_post_update"] == before + 1, "the post-update was not launched")
    check(torch.equal(kb["colloc"], drawn) and torch.equal(pb["colloc"], drawn),
          "the post-update's batch is not philox_uniform's")
    km, pm, em = (dict(zip(tr.METRIC_KEYS, host(b["metrics"][1]))) for b in (kb, pb, eb))
    z_scale = float(pb["z"].abs().max())
    post_rows = {
        "z": hold_post("z", host(kb["z"]), host(pb["z"]), host(eb["z"])),
        "dual": hold_post("dual", host(kb["dual"]), host(pb["dual"]), host(eb["dual"]),
                          scale=float(admm.dual.abs().max()) + rho * z_scale),
        "admm_misfit": hold_post("admm_misfit", km["admm_misfit"], pm["admm_misfit"],
                                 em["admm_misfit"], scale=z_scale),
        "data_term": hold_post("data_term", km["data_term"], pm["data_term"], em["data_term"])}
    check(float(kb["metrics"][[0, 2]].abs().max()) == 0.0 and int(kb["cursor"][0]) == 2,
          "the post-update wrote another row or left the cursor")
    check(km["loss"] == np.float32(0.5) and km["lbfgs_iters"] == 61.0
          and km["res_term"] == np.float32(np.float32(0.5) - np.float32(km["data_term"]))
          and (km["lambda1"], km["lambda2"]) == (np.float32(lcfg["lam1"]), np.float32(lcfg["lam2"])),
          f"the post-update's metrics row {km}")

    # -- (b) chunks of L outer epochs against L chunks of one, bit for bit
    capped = dataclasses.replace(problem, exp=override(exp, {
        "optimizer.lbfgs.max_iters": CHUNK_MAX_ITERS}))
    runner = k_lbfgs.LBFGSChunk(capped, max_len=max(CHUNK_LENGTHS))
    state0 = tr.TrainState(params=params, opt_state=None, admm=admm, colloc=colloc, key=seed,
                           epoch=REPLAY_STEP, rho=None)
    flat = lambda st: lb_mod.ravel_tree(st.params)[0]  # noqa: E731
    bits = {}
    reset_counts()
    for length in CHUNK_LENGTHS:
        for fed in (False, True):
            feed = torch.stack([points(n_f, seed=100 * length + i, device="cuda")
                                for i in range(length)]) if fed else None
            got, gm = runner.run(state0, length, feed)
            one, ms = state0, []
            for i in range(length):
                one, m = runner.run(one, 1, None if feed is None else feed[i:i + 1])
                ms.append(m)
            torch.cuda.synchronize()
            same = (torch.equal(flat(got), flat(one)) and torch.equal(got.colloc, one.colloc)
                    and torch.equal(got.admm.z, one.admm.z)
                    and torch.equal(got.admm.dual, one.admm.dual)
                    and all(torch.equal(gm[k], torch.cat([m[k] for m in ms]))
                            for k in tr.METRIC_KEYS))
            check(same and got.epoch == one.epoch == REPLAY_STEP + length,
                  f"a chunk of {length} ({'fed' if fed else 'drawn'}) differs from "
                  f"{length} one-epoch chunks")
            check(not fed or torch.equal(got.colloc, feed[-1]), "the fed batch")
            bits[f"L{length}_{'fed' if fed else 'drawn'}"] = {
                "bit_equal": True, "lbfgs_iters": [int(v) for v in gm["lbfgs_iters"].tolist()]}
    bit_counts = kernel_counts()
    # one launch of the solve's loop an outer epoch, one read of the device a
    # chunk (after it: none inside)
    check(bit_counts["lbfgs_chunk_epochs"] == bit_counts["lbfgs_loop_launches"]
          == 4 * sum(CHUNK_LENGTHS)
          and bit_counts["lbfgs_host_syncs"] == 2 * sum(1 + n for n in CHUNK_LENGTHS),
          f"counts {bit_counts}")

    # -- (c) one outer epoch from the fixture's state against JAX's iterate
    five = k_lbfgs.LBFGSChunk(dataclasses.replace(problem, exp=override(exp, {
        "optimizer.lbfgs.max_iters": 5})), max_len=1)
    got, gm = five.run(state0, 1)
    want = fx["x_5"].astype(np.float64)
    err = float(np.abs(host(flat(got)).astype(np.float64) - want).max())
    step = float(np.abs(want - fx["x0"].astype(np.float64)).max())
    bnd = ITERATE_STEP_TOL * step + ITERATE_ULP_TOL * float(np.abs(want).max())
    check(err <= bnd, f"the chunk's outer epoch x: err {err} > {bnd}")
    check(int(gm["lbfgs_iters"][0]) == int(fx["n_iters_5"]),
          f"n_iters {int(gm['lbfgs_iters'][0])} != JAX {int(fx['n_iters_5'])}")
    jax_row = {"max_abs_err": err, "bound": bnd, "jax_step": step,
               "n_iters": int(gm["lbfgs_iters"][0]),
               "f": close("loss", float(gm["loss"][0]), float(fx["f_5"]))}

    # -- (d) times: an outer epoch on the runner and on the per-outer-epoch
    # step, from phase 9's state at phase 14's schedule, in turns
    with np.load(LBFGS_FIXTURE, allow_pickle=False) as z:
        max_iters = int(z["hybrid_max_iters"])
    tproblem = tr.build_problem(override(get_preset("abgrall_admm"), {
        "optimizer.lbfgs.max_iters": max_iters}), "cuda")
    trunner = k_lbfgs.LBFGSChunk(tproblem, max_len=HYBRID_OUTER)
    tstep = tr.make_lbfgs_step(tproblem)
    st9 = adam["state"]
    sides = {"runner": lambda: trunner.run(st9, HYBRID_OUTER),
             "per_outer_epoch_step": lambda: tr.run_chunk(tstep, st9, HYBRID_OUTER)}
    walls = {k: [] for k in sides}
    iters = {}
    for name, fn in sides.items():  # the captures, outside the times
        fn()
    for _ in range(CHUNK_TURNS):
        for name, fn in sides.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            iters[name] = [int(v) for v in m["lbfgs_iters"].tolist()]
    times = {}
    for name, fn in sides.items():
        with SolveClock() as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            split = 1e3 * (time.perf_counter() - t0)
        prof = device_profile(fn)
        wall_ms = 1e3 * statistics.median(walls[name])
        times[name] = {
            "ms_per_outer_epoch": wall_ms / HYBRID_OUTER,
            "wall_ms": [1e3 * w for w in walls[name]],
            "split_ms_per_outer_epoch": split / HYBRID_OUTER,
            "solve_ms_per_outer_epoch": clock.ms / HYBRID_OUTER,
            "outside_solve_ms_per_outer_epoch": (split - clock.ms) / HYBRID_OUTER,
            "device_us_per_outer_epoch": None if prof["device_us"] is None
            else prof["device_us"] / HYBRID_OUTER,
            "launches_per_outer_epoch": None if prof["kernels"] is None
            else prof["kernels"] / HYBRID_OUTER,
            "idle_share": None if prof["device_us"] is None
            else 1.0 - prof["device_us"] / (1e3 * wall_ms),
            "lbfgs_iters": iters[name]}
    times["runner"]["capture_s"] = trunner.capture_seconds + trunner.solver.capture_seconds
    n_all = sum(t.numel() for t in tree_leaves(st9.params))
    pbound = post_update_bound(spec.layers, n_f, n_u)
    outer = [outer_epoch_bound(n_all, k, tproblem.exp.optimizer.lbfgs.history, n_f, n_u,
                               pbound)[0] for k in iters["runner"]]
    times["runner"]["bound_ms_per_outer_epoch"] = statistics.mean(outer)
    times["runner"]["bound_by"] = "operations"

    # -- (e) the post-update mode's device time: a graph of K10_REPS calls,
    # each after the cursor's reset, less a graph of the resets alone
    kb["cursor"].zero_()
    kernel_ms = graph_ms(lambda: (kb["cursor"].zero_(), post(
        k_fused._post_update_call, kb, launch_only=True))) - graph_ms(
        lambda: kb["cursor"].zero_())
    plain_ms = event_ms(lambda: (pb["cursor"].zero_(), post(k_fused.post_update_reference, pb)))
    emit(card, phase="lbfgs-chunk", state=f"abgrall_admm_steps.npz step {REPLAY_STEP}",
         post_update=post_rows, chunks=bits, chunk_max_iters=CHUNK_MAX_ITERS, jax=jax_row,
         times=times, schedule={"outer": HYBRID_OUTER, "max_iters": max_iters,
                                "turns": CHUNK_TURNS},
         kernel={"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": pbound[0],
                 "bound_by": pbound[1]},
         clock="host for the outer epochs (the solves bracketed by synchronizes in the split "
               "turn), the profiler for their device time, events over a captured graph for "
               "the post-update mode, events for its plain version")
    return {"kernel": (kernel_ms, plain_ms), "bound": pbound, "times": times,
            "max_abs_err": post_rows["z"]["max_abs_err"]}


# -- 41: K9 for the generic step and K11, the Philox draw ---------------------------

GENERIC_FAMILIES = ("euler_admm", "euler_admm_tuned", "twosin_weak", "euler_weak_fast",
                    "euler_inverse", "burgers_forward", "hwan_admm", "burgers_inverse")
GENERIC_TIMED = ("euler_admm", "twosin_weak", "euler_weak_fast", "euler_inverse",
                 "burgers_forward")
GENERIC_LENGTHS = (1, 2, 7)
GENERIC_SPLIT = 50  # 2 x 50 against 1 x 100 and the per-epoch loop's 100
GENERIC_FED = 7  # epochs of the fed chunks
GENERIC_CHUNK = 1_000  # the timed graphed chunk
GENERIC_LOOP = 200  # the timed per-epoch loop (its ms an epoch do not depend on the length)
GENERIC_TURNS = 3  # alternating turns a side
GENERIC_PROFILED = (100, 20)  # epochs under the profiler: graphed, per-epoch
GENERIC_MEMBERS = ("twosin_weak", 3, 20)  # an ensemble on the member loop: E, epochs
K11_NS = (1_000, 1_048_576)  # the presets' batches; burgers_scale's
K11_EPOCHS = (0, 1, 2**32 + 5)


def k11_bound(n: int):
    """K11 writes 8 n bytes and reads one schedule row and the cursor; its
    floating point is 3 operations a coordinate (Philox's integer rounds are
    not in the card's table of peak rates)."""
    return bound([(6.0 * n, PEAK_FP32)], 8 * n + 72 + 8)


def generic_epoch_bound(trainer):
    """The least time of a generic Adam epoch: the sum of its net kernels'
    bounds (the loss forward and backward at the residual points, the
    tail's forward at the new points for ADMM, the data term's K5 forward
    and backward); K7b, K11 and the elementwise ops left out (bytes, small)."""
    exp, spec = trainer.exp, trainer.problem.spec
    n_f, n_u = exp.sampling.n_f, int(trainer.problem.x_data.shape[0])
    if exp.sampling.strategy != "resample_uniform":
        n_f = int(trainer.init_state().colloc.shape[0])
    layers = spec.widths
    parts = [mlp_bound(layers, n_u), mlp_bound(layers, n_u, backward=True)]
    if trainer.problem.flux:
        edge = 4 * exp.loss.flux_quad * n_f  # the cells' edge points
        parts += [taylor1_bound(layers, edge), taylor1_backward_bound(layers, edge)]
        if exp.loss.strong_equations:
            parts += [taylor1_bound(layers, n_f), taylor1_backward_bound(layers, n_f)]
    elif exp.pde.kind == "euler":
        parts += [taylor1_bound(layers, n_f), taylor1_backward_bound(layers, n_f)]
    else:
        parts += [taylor2_bound(layers, n_f), taylor2_backward_bound(layers, n_f)]
    if exp.loss.residual_kind == "admm":
        parts.append(taylor1_bound(layers, n_f) if exp.pde.kind == "euler"
                     else taylor2_bound(layers, n_f))
    return sum(p[0] for p in parts), "operations"


def phase_generic_chunk(card: str) -> dict:
    """41: K11 against philox_uniform bit for bit (n 1,000 and 1,048,576,
    epochs 0, 1, 2^32 + 5, from the schedule row at the device cursor); the
    multi-tensor Adam with its rate and bias corrections as device tensors
    beside host scalars on the card (reported); for each generic family in
    scope, the graphed chunk (K9 for the generic step) against the per-epoch
    loop by torch.equal on params, mu, nu, colloc, z, dual and every metrics
    row at L = 1, 2, 7 and 2 x 50 = 1 x 100 (= the loop's 100), drawn, and
    at L 7 fed; then, for the timed presets, 1,000-epoch graphed chunks
    against the per-epoch loop in alternating turns: ms an epoch (host
    clock), device time, idle share and launches an epoch (the profiler),
    step calls and graph replays an epoch."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.data.sampling import philox_uniform
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import generic_chunk as k_generic
    from pinns_tpu_torch.ops.kernels import sampling as k_sampling
    from pinns_tpu_torch.opt.adam import AdamState, adam_update, bias_corrections
    from pinns_tpu_torch.train import schedule
    from pinns_tpu_torch.train import trainer as tr

    # K11: bit for bit, and its times beside the plain draw at the same shapes
    lb, ub = (-1.0, 0.0), (1.0, float(np.float32(0.37)))
    cursor = torch.ones(1, dtype=torch.int64, device="cuda")
    k11 = {}
    for n in K11_NS:
        for epoch in K11_EPOCHS:
            rows = np.concatenate([schedule.schedule_rows(1234, 0, e, 1, 1e-3,
                                                          lambda e: (lb, ub))
                                   for e in (7, epoch - 1)])
            sched = torch.from_numpy(rows).cuda()
            got = k_sampling.philox_draw(sched, cursor, n)
            want = philox_uniform(1234, epoch, n, lb, ub, torch.float32, "cuda")
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K11 differs from philox_uniform at n {n}, "
                  f"epoch {epoch}")
        ms = graph_ms(lambda: k_sampling.philox_draw(sched, cursor, n))
        plain = event_ms(lambda: philox_uniform(1234, 5, n, lb, ub, torch.float32, "cuda"))
        k11[n] = (ms, plain, k11_bound(n))
        emit(card, phase="times", what="k11", n=n, kernel_ms=ms, plain_ms=plain,
             clock="cuda_events (kernel: a captured graph of launches)", bound_ms=k11_bound(n)[0],
             bound_by=k11_bound(n)[1], plain="philox_uniform (torch int64 ops)")
    # Adam's divisions by device tensors against host scalars, on the card
    gen = torch.Generator().manual_seed(41)
    leaves = [torch.randn(s, generator=gen).cuda() for s in ((200, 200), (1, 200), (200, 3))]
    mu = [torch.randn(t.shape, generator=gen).cuda() * 1e-3 for t in leaves]
    nu = [torch.rand(t.shape, generator=gen).cuda() * 1e-6 for t in leaves]
    opt = AdamState(count=1234, mu=mu, nu=nu)
    bc = bias_corrections(1234)
    host = adam_update(leaves, opt, 1e-3)[0]
    dev = adam_update(leaves, opt, torch.tensor(1e-3, device="cuda"),
                      bias=tuple(torch.tensor(v, device="cuda") for v in bc))[0]
    adam_diff = max(float((a - b).abs().max()) for a, b in zip(host, dev))
    adam_same = all(torch.equal(a, b) for a, b in zip(host, dev))

    errs, cases = [], {}

    def held(name, got, want):
        errs.append(hold_chunk(name, got, want))
        cases[name] = True

    reset_counts()
    for preset in GENERIC_FAMILIES:
        trainer = tr.Trainer(get_preset(preset), device="cuda")
        check(not k_generic.generic_chunk_supported(trainer.exp, trainer.problem.spec),
              f"{preset} outside the generic chunk's scope")
        run = trainer._get_chunk("adam")
        check(isinstance(getattr(run, "runner", None), k_generic.GenericChunk),
              f"{preset}: the chunk is not graphed")
        step, state = trainer._adam_step, trainer.init_state()
        for length in GENERIC_LENGTHS:
            held(f"{preset}-L{length}", run(state, length), tr.run_chunk(step, state, length))
        half = run(state, GENERIC_SPLIT)
        rest = run(half[0], GENERIC_SPLIT)
        whole = run(state, 2 * GENERIC_SPLIT)
        two = (rest[0], {k: torch.cat([half[1][k], rest[1][k]]) for k in rest[1]})
        held(f"{preset}-2x{GENERIC_SPLIT}-vs-1x{2 * GENERIC_SPLIT}", two, whole)
        held(f"{preset}-L{2 * GENERIC_SPLIT}-vs-loop", whole,
             tr.run_chunk(step, state, 2 * GENERIC_SPLIT))
        n = int(state.colloc.shape[0])
        feed = points(GENERIC_FED * n, seed=41, device="cuda").view(GENERIC_FED, n, 2)
        held(f"{preset}-fed-L{GENERIC_FED}", run(state, GENERIC_FED, feed),
             tr.run_chunk(step, state, GENERIC_FED, feed))
    # the ensemble's member loop: each member through the solo runner, equal
    # to its solo chunk and to the per-epoch loop
    from pinns_tpu_torch.parallel import ensemble as ens

    preset, n_members, epochs = GENERIC_MEMBERS
    trainer = tr.Trainer(get_preset(preset), device="cuda")
    seeds = [1234 + i for i in range(n_members)]
    stacked = ens.init_ensemble_states(trainer, seeds)
    got_stack, got_m = ens.make_ensemble_chunk(trainer, epochs)(stacked)
    for i, (member, solo) in enumerate(zip(ens.unstack_states(got_stack, n_members),
                                           (trainer.init_state(seed=s) for s in seeds))):
        want = trainer._get_chunk("adam")(solo, epochs)
        loop = tr.run_chunk(trainer._adam_step, solo, epochs)
        mine = (member, {k: v[:, i] for k, v in got_m.items()})
        held(f"{preset}-member{i}-vs-solo-chunk", mine, want)
        held(f"{preset}-member{i}-vs-loop", mine, loop)
    counts = kernel_counts()
    emit(card, phase="generic-chunk", criterion="torch.equal of every output and metrics row "
         "vs the per-epoch loop", cases=cases, max_abs_err=max(errs),
         k11_criterion="torch.equal vs philox_uniform", k11_ns=list(K11_NS),
         k11_epochs=list(K11_EPOCHS), adam_device_scalars_equal_host=adam_same,
         adam_device_scalars_max_diff=adam_diff, replays=counts["generic_chunk_replays"],
         replayed_epochs=counts["generic_chunk_epochs"],
         captures=counts["generic_chunk_captures"])

    times = {}
    for preset in GENERIC_TIMED:
        trainer = tr.Trainer(override(get_preset(preset), {"train.chunk": GENERIC_CHUNK}),
                             device="cuda")
        run, state = trainer._get_chunk("adam"), trainer.init_state()
        runner = run.runner
        step = trainer._adam_step
        calls = {"step": 0, "epoch": 0}

        def counted_step(*a, **k):
            calls["step"] += 1
            return step(*a, **k)

        epoch_fn = runner.epoch

        def counted_epoch(*a, **k):
            calls["epoch"] += 1
            return epoch_fn(*a, **k)

        runner.epoch = counted_epoch
        sides = {"graphed": (GENERIC_CHUNK, lambda: run(state, GENERIC_CHUNK)),
                 "per_epoch": (GENERIC_LOOP,
                               lambda: tr.run_chunk(counted_step, state, GENERIC_LOOP))}
        for _, fn in sides.values():  # captures and warms up
            fn()
        torch.cuda.synchronize()
        reset_counts()
        calls.update(step=0, epoch=0)
        wall = {k: [] for k in sides}
        for turn in range(GENERIC_TURNS):
            order = list(sides.items())
            for side, (length, fn) in (order if turn % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall[side].append(1e3 * (time.perf_counter() - t0) / length)
        counts = kernel_counts()
        check(counts["generic_chunk_epochs"] == GENERIC_TURNS * GENERIC_CHUNK
              and calls["epoch"] == 0 and calls["step"] == GENERIC_TURNS * GENERIC_LOOP,
              f"{preset}: replayed epochs {counts['generic_chunk_epochs']}, epoch calls "
              f"{calls['epoch']}, step calls {calls['step']}")
        ms = {k: statistics.median(v) for k, v in wall.items()}
        prof = {"graphed": device_profile(lambda: run(state, GENERIC_PROFILED[0])),
                "per_epoch": device_profile(
                    lambda: tr.run_chunk(step, state, GENERIC_PROFILED[1]))}
        dev, launches, idle = {}, {}, {}
        for side, epochs in zip(("graphed", "per_epoch"), GENERIC_PROFILED):
            us = prof[side]["device_us"]
            dev[side] = None if us is None else us / epochs / 1e3
            launches[side] = None if us is None else prof[side]["kernels"] / epochs
            idle[side] = None if us is None else max(0.0, 1.0 - dev[side] / ms[side])
        k11_us = sum(v["us"] for k, v in prof["graphed"]["by_name"].items()
                     if "k11::" in k) / GENERIC_PROFILED[0]
        b = generic_epoch_bound(trainer)
        emit(card, phase="times", what="generic_chunk", preset=preset,
             epochs=GENERIC_CHUNK, loop_epochs=GENERIC_LOOP, turns=GENERIC_TURNS, clock="host",
             graphed_ms_per_epoch=ms["graphed"], per_epoch_ms_per_epoch=ms["per_epoch"],
             graphed_turns=wall["graphed"], per_epoch_turns=wall["per_epoch"],
             speedup=ms["per_epoch"] / ms["graphed"], device_ms_per_epoch=dev,
             idle_share=idle, launches_per_epoch=launches, k11_device_us_per_epoch=k11_us,
             step_calls_per_epoch={"graphed": 0.0, "per_epoch": calls["step"] / (
                 GENERIC_TURNS * GENERIC_LOOP)},
             graph_replays_per_epoch={"graphed": counts["generic_chunk_replays"] / (
                 GENERIC_TURNS * GENERIC_CHUNK), "per_epoch": 0.0},
             capture_s=runner.capture_seconds[0], epoch_bound_ms=b[0], bound_by=b[1],
             profiled_epochs=list(GENERIC_PROFILED))
        times[preset] = (ms["graphed"], ms["per_epoch"], b, dev, idle, launches)
    return {"max_abs_err": max(errs), "k11": k11, "times": times}


# -- 42-45: the rest of slice 2b-iii: Fourier features in K1/K2, K7a and K5,
# K1/K2's shock paths, the weak-form ADMM, RAD and SWA ---------------------------

SLICE2B_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "slice2b_rest.npz")
# (family, widths, N, Fourier features F, paths K): PARITY's setting F 16 at
# sigma 3; K1 at 8x20 (input width 34) and 8x200, K2 at 8x20, both with two
# paths; K7a at the Euler trunk with and without paths; K5 at the trunk
FEATURE_CASES = [("taylor2", NARROW, 25_600, 16, 0), ("taylor2", WIDE, 8_192, 16, 0),
                 ("taylor2", NARROW, 1_000, 16, 0), ("taylor2", NARROW, 1_000, 0, 2),
                 ("taylor1", EULER, 1_000, 16, 0), ("taylor1", EULER, 16_000, 16, 0),
                 ("taylor1", EULER, 1_000, 16, 2), ("taylor1", EULER, 16_000, 16, 2),
                 ("mlp", EULER, 1_000, 16, 0)]
FOURIER_SIGMA = 3.0
FOURIER_UPDATE = {"model.n_fourier": 16}
FOURIER_TRAIN_EPOCHS = 2_000  # phase 43's burgers_forward run
FEATURE_RUN_EPOCHS = 300  # phase 43's launch-counting runs of the other feature presets
FEATURE_CHUNK_LEN = 7  # the graphed chunk held against the per-epoch loop
FLUX_UPDATE = {"loss.admm_form": "flux"}
FLUX_LBFGS_ITERS = 50
RAD_CHUNK, RAD_CHUNKS = 50, 4  # phase 45: three chunk boundaries with their redraws
SWA_RUN = {"epochs": 1_000, "chunk": 100, "frac": 0.25}
SWA_ENSEMBLE = {"members": 3, "epochs": 300, "chunk": 100, "frac": 0.25}


def slice2b_fixture() -> dict:
    with np.load(SLICE2B_FIXTURE, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def numpy_net(widths, seed: int) -> list:
    """scripts/make_torch_slice2b_fixture.py::numpy_net: JAX-layout float32
    params from a numpy seed (W at the init's scale, clipped at 2 sigma; b 0.1
    N(0, 1))."""
    rng = np.random.default_rng(seed)
    out = []
    for din, dout in zip(widths[:-1], widths[1:]):
        std = math.sqrt(2.0 / (din + dout))
        out.append({"W": (std * np.clip(rng.standard_normal((din, dout)), -2.0, 2.0))
                    .astype(np.float32),
                    "b": (0.1 * rng.standard_normal((1, dout))).astype(np.float32)})
    return out


def flat_net(flat: np.ndarray, widths) -> list:
    """A flat W_0, b_0, W_1, ... vector as JAX-layout numpy params."""
    leaves = split_leaves(flat, widths)
    return [{"W": w.reshape(din, dout), "b": b.reshape(1, dout)}
            for w, b, din, dout in zip(leaves[0::2], leaves[1::2], widths[:-1], widths[1:])]


def feature_net(layers, f: int, k: int, seed: int):
    """A net with F Fourier features (sigma 3, B from ``seed``) and K shock
    paths moved off their init, nonzero biases, and its float64 twin."""
    from pinns_tpu_torch.models.mlp import MLPSpec, fourier_matrix, init_mlp

    spec = MLPSpec(layers=layers, lb=LB, ub=UB, n_paths=k, path_degree=2, path_sharpness=12.0,
                   fourier=fourier_matrix(f, sigma=FOURIER_SIGMA, seed=seed) if f else ())
    params = init_mlp(spec, torch.Generator().manual_seed(seed), "cuda")
    gen = torch.Generator().manual_seed(seed + 1)
    for p in params:
        p["b"].copy_(0.1 * torch.randn(p["b"].shape, generator=gen))
    if k:
        params[0]["path_c"].add_(0.3 * torch.randn((k, 3), generator=gen).cuda())
        params[0]["path_a"].mul_(1.0 + 0.2 * torch.randn(k, generator=gen).cuda())
    return spec, params, dataclasses.replace(spec, dtype=torch.float64), net_f64(params)


def feature_fns(family: str):
    """(kernel forward, kernel backward, plain forward, plain backward,
    streams) of a kernel family: forward(spec, params, x) -> output tuple,
    backward(spec, params, x, cot) -> the kernel's flat gradient or the plain
    version's leaves."""
    from pinns_tpu_torch.models.mlp import mlp_apply_reference
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor1 as k_taylor1
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.ops.taylor import mlp_taylor_1_reference, mlp_taylor_2_reference

    if family == "taylor2":
        return (k_taylor2.taylor2, k_taylor2.taylor2_backward, mlp_taylor_2_reference,
                k_taylor2.taylor2_backward_reference, 4)
    if family == "taylor1":
        return (k_taylor1.taylor1, k_taylor1.taylor1_backward, mlp_taylor_1_reference,
                k_taylor1.taylor1_backward_reference, 3)
    return (lambda s, p, x: (k_mlp.mlp_forward(s, p, x),),
            lambda s, p, x, c: k_mlp.mlp_backward(s, p, x, c[0]),
            lambda s, p, x: (mlp_apply_reference(s, p, x),),
            lambda s, p, x, c: k_mlp.mlp_backward_reference(s, p, x, c[0]), 1)


def embed_ops(spec, n: int, streams: int):
    """The input pass's own work a call: per point and Fourier feature the
    phase (2 FLOP), sin and cos counted as one operation each (a lower bound:
    the card's accurate sinf and cosf take a range reduction and a
    polynomial), and the derivative streams' products (2 FLOP each of the x
    and t streams, 4 of the xx stream); per path and point about 20 FLOP for
    the value stream and 10 more a tangent stream (path_ops)."""
    per = 4.0 + 2.0 * min(streams - 1, 2) * 2 + (4.0 if streams == 4 else 0.0)
    return [(per * spec.n_fourier * n, PEAK_FP32)] + path_ops(spec, n, streams)


def feature_bound(family: str, spec, n: int, backward: bool):
    """(bound_ms, bound_by) of a feature call: the trunk's products at the
    embedded widths (spec.widths) as each kernel's bound counts them, plus
    the input pass's work (embed_ops; the backward recomputes it, and with
    paths applies their chain rule, counted as twice more)."""
    w = spec.widths
    streams = {"taylor2": 4, "taylor1": 3, "mlp": 1}[family]
    nbytes = 8 * n + 4 * streams * n * w[-1] + 4 * spec.n_params
    if family == "taylor2":
        ops = taylor2_ops(w, n)
        if backward:
            ops = ops + [(2 * 8.0 * sum(_macs(w)) * n, PEAK_FP32)]
    elif family == "taylor1":
        ops = taylor1_ops(w, n)
        if backward:
            m = _macs(w)
            ops = ops + [(3 * 2.0 * (sum(m) + sum(m[1:]) + (m[0] if spec.n_paths else 0)) * n,
                          PEAK_FP32)]
    else:
        ops = [((3.0 if backward else 1.0) * 2.0 * sum(_macs(w)) * n, PEAK_FP32)]
    extra = embed_ops(spec, n, streams)
    if backward:
        extra = extra + (path_ops(spec, n, streams) * 2 if spec.n_paths else [])
        nbytes += 4 * spec.n_params
    return bound(ops + extra, nbytes)


def phase_features(card: str) -> dict:
    """42: K1/K2 (tiled), K7a (wide) and K5 (wide) with Fourier features (F
    16, sigma 3) and K1/K2 with shock paths, against the plain float32
    version and float64 (compare_f64) on every stream and every gradient
    leaf (path_c and path_a included); two backward calls bit for bit; then
    event times of each kernel beside its plain version and beside the same
    kernel on the same widths without the features."""
    out = {}
    for family, layers, n, f, k in FEATURE_CASES:
        kfwd, kbwd, pfwd, pbwd, streams = feature_fns(family)
        spec, params, spec64, params64 = feature_net(layers, f, k, 420 + n % 97)
        x = points(n, seed=n + 42, device="cuda")
        rng = np.random.default_rng(n + 43)
        cot = [torch.from_numpy(rng.standard_normal((n, layers[-1])).astype(np.float32))
               .cuda() for _ in range(streams)]
        with torch.inference_mode():
            got, grad = kfwd(spec, params, x), kbwd(spec, params, x, cot)
            again = kbwd(spec, params, x, cot)
            plain, pgrad = pfwd(spec, params, x), pbwd(spec, params, x, cot)
            exact = pfwd(spec64, params64, x.double())
            egrad = pbwd(spec64, params64, x.double(), [c.double() for c in cot])
        torch.cuda.synchronize()
        tag = f"{family} {len(layers) - 2}x{max(layers[1:])} F{f} K{k} N {n}"
        check(torch.equal(grad, again), f"{tag}: two backward calls differ")
        check(grad.numel() == spec.n_params, f"{tag}: {grad.numel()} gradient entries")
        rows = {f"out{i}": compare_f64(f"{tag} out{i}", host(g), host(p), host(e))
                for i, (g, p, e) in enumerate(zip(got, plain, exact))}
        leaves, off = [], 0
        for p, e in zip(pgrad, egrad):
            g = host(grad[off:off + p.numel()])
            off += p.numel()
            leaves.append(dict(compare_f64(f"{tag} grad", g, host(p).ravel(), host(e).ravel()),
                               max_abs_err=float(np.abs(g - host(p).ravel()).max())))
        fwd_err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
        bwd_err = max(r["max_abs_err"] for r in leaves)
        bare, bare_params, _, _ = feature_net(layers, 0, 0, 420 + n % 97)
        with torch.inference_mode():
            t = {"forward": event_ms(lambda: kfwd(spec, params, x)),
                 "backward": event_ms(lambda: kbwd(spec, params, x, cot)),
                 "plain_forward": event_ms(lambda: pfwd(spec, params, x)),
                 "plain_backward": event_ms(lambda: pbwd(spec, params, x, cot)),
                 "no_features_forward": event_ms(lambda: kfwd(bare, bare_params, x)),
                 "no_features_backward": event_ms(lambda: kbwd(bare, bare_params, x, cot))}
        b = {"forward": feature_bound(family, spec, n, False),
             "backward": feature_bound(family, spec, n, True)}
        out[(family, layers, n, f, k)] = {"errs": (fwd_err, bwd_err), "times": t, "bounds": b}
        emit(card, phase="fourier-kernels", kernel=family, net=f"{len(layers) - 2}x"
             f"{max(layers[1:])}", input_width=spec.widths[0], n_fourier=f, n_paths=k, n=n,
             criterion="f64_oracle", outputs=rows, forward_max_abs_err=fwd_err,
             backward_max_abs_err=bwd_err, leaves=len(leaves), bit_equal=True,
             reps=REPS, clock="cuda_events",
             **{f"{key}_ms": v for key, v in t.items()},
             forward_bound_ms=b["forward"][0], backward_bound_ms=b["backward"][0],
             bound_by=[b["forward"][1], b["backward"][1]],
             plain="the plain forward and the hand-written reverse mode in PyTorch")
    return out


def feature_entry(runs: dict, counter: str, res: dict, case, which: str, run: str) -> dict:
    """A feature mode's keys in the kernels line: its launches in phase
    43's ``run``, its error and times (phase 42) at ``case``, forward or
    backward (``which``), beside the same kernel without the features."""
    r = res[case]
    i = 0 if which == "forward" else 1
    return {"launches": runs[run]["launches"][counter], "max_abs_err": r["errs"][i],
            "ms": r["times"][which], "plain_ms": r["times"][f"plain_{which}"],
            "no_features_ms": r["times"][f"no_features_{which}"],
            **bound_fields(r["bounds"][which])}


def kernel_gradient(problem, state, plain: bool, dtype=torch.float32):
    """(loss, flat net gradient in net_leaves order) of the training loss at
    ``state`` through the kernels (or the plain versions), in ``dtype``."""
    from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves
    from pinns_tpu_torch.train import trainer as tr

    cast = lambda t: t.to(dtype).detach().clone()  # noqa: E731
    params = tr.tree_map(lambda t: cast(t).requires_grad_(True), state.params)
    admm = None
    if state.admm is not None:
        admm = type(state.admm)(z=tr.tree_map(cast, state.admm.z),
                                dual=tr.tree_map(cast, state.admm.dual))
    loss, _ = tr.make_loss_fn(problem, plain=plain)(params, state.colloc.to(dtype), admm)
    leaves = net_leaves(params["net"])
    return float(loss.detach()), flat_np(torch.autograd.grad(loss, leaves))


def fixture_state(problem, net, colloc, device, z=None, dual=None, own_admm=False):
    """A port TrainState at JAX-layout ``net``, the preset's initial
    coefficients, a fresh Adam state and ``colloc``; ADMM's z and dual given,
    or (``own_admm``) initialized by the port at the batch (z = r(w_0), dual
    = 1), as each side's init does."""
    from pinns_tpu_torch.interop import train_state_from_jax
    from pinns_tpu_torch.train import trainer as tr

    exp = problem.exp
    coeffs = {"lambda1": np.full(1, exp.pde.lambda1, np.float32),
              "lambda2": np.full(1, exp.pde.lambda2, np.float32)}
    zeros = lambda tree: [{k: np.zeros_like(v) for k, v in layer.items()}  # noqa: E731
                          for layer in tree]
    zc = {k: np.zeros_like(v) for k, v in coeffs.items()}
    tree = {"params": {"net": net, "coeffs": coeffs}, "count": 0,
            "mu": {"net": zeros(net), "coeffs": zc}, "nu": {"net": zeros(net), "coeffs": zc},
            "colloc": colloc, "epoch": 0}
    if z is not None:
        split = lambda a: tuple(a[:, i:i + 1] for i in range(a.shape[1]))  # noqa: E731
        tree["z"], tree["dual"] = split(z), split(dual)
    state = train_state_from_jax(tree, device, key=int(exp.train.seed))
    if own_admm:
        with torch.no_grad():
            state = state._replace(admm=tr.admm_init(problem.training_residuals(
                state.params, state.colloc)))
    return state


def cell_error(problem, p64, params, colloc) -> float:
    """float32's own error in the weak-form cell residuals at (params,
    colloc): max |plain float32 - plain float64| over the components (a cell
    residual is a difference quotient of edge means, whose rounding it
    amplifies)."""
    from pinns_tpu_torch.train import trainer as tr

    with torch.no_grad():
        r32 = problem.flux_residuals_and_entropy(params, colloc, plain=True)[0]
        r64 = p64.flux_residuals_and_entropy(tr.tree_map(lambda t: t.double(), params),
                                             colloc.double(), plain=True)[0]
    return max(float((a.double() - b).abs().max()) for a, b in zip(r32, r64))


def hold_cells(k: int, got, want, e_r: float, carry: float, rho: float) -> tuple:
    """z and the dual of the weak-form ADMM after step k against JAX's,
    beside the float32 cell error ``e_r`` at that step (cell_error): z =
    S(r + dual / rho) may differ by each side's error in r (at most 4 e_r,
    the float64 criterion's factor) plus the dual's difference ``carry`` /
    rho; the dual += rho (r - z) by ``carry`` + rho (4 e_r + z's bound).
    Returns the rows and the dual's bound (the next step's carry)."""
    z, dual = got
    jz, jdual = want
    tol_z = F64_FACTOR * e_r + carry / rho + STEP_TOL["z"][1] * float(np.abs(jz).max())
    tol_d = carry + rho * (F64_FACTOR * e_r + tol_z) + \
        STEP_TOL["dual"][1] * float(np.abs(jdual).max())
    rows = {"z": {"max_abs_err": float(np.abs(z - jz).max()), "bound": tol_z, "cell_err": e_r},
            "dual": {"max_abs_err": float(np.abs(dual - jdual).max()), "bound": tol_d}}
    check(rows["z"]["max_abs_err"] <= tol_z and rows["dual"]["max_abs_err"] <= tol_d,
          f"step {k}: z / dual against JAX {rows}")
    return rows, tol_d


def replay_steps(problem, step, state, fx: dict, p: str, lr: float, fed: bool,
                 admm: bool = False, p64=None):
    """The fixture's JAX replay: each step fed JAX's next batch (``fed``),
    its metrics, each leaf's sums and (``admm``) z and the dual on the new
    batch after it, the params after the first step. With ``p64`` (the
    float64 problem of a weak-form ADMM) z, the dual and the misfit are held
    beside float32's own cell error (hold_cells). Returns the rows and the
    state."""
    from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves
    from pinns_tpu_torch.train import trainer as tr

    carry = 0.0  # the dual's bound so far: both start at 1
    rho = problem.exp.loss.rho
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(problem.device)  # noqa: E731
    rows, k = [], 1
    while f"{p}metrics_{k}" in fx:
        state, m = step(state, new_colloc=t(fx[f"{p}colloc_{k}"]) if fed else None)
        m = {n: float(v) for n, v in m.items()}
        want = dict(zip(tr.METRIC_KEYS, fx[f"{p}metrics_{k}"].tolist()))
        r = {n: close("loss", m[n], want[n], scale=abs(want["loss"]))
             for n in ("loss", "data_term", "res_term")}
        got = [host(v).astype(np.float64) for v in net_leaves(state.params["net"])]
        r["leaf_sums"] = close("leaf_sums", np.asarray([(v.sum(), (v * v).sum()) for v in got]),
                               fx[f"{p}sums_{k}"])
        if admm:
            z = np.concatenate([host(c) for c in state.admm.z], 1)
            dual = np.concatenate([host(c) for c in state.admm.dual], 1)
            if p64 is None:
                r["z"] = close("z", z, fx[f"{p}z_{k}"])
                r["dual"] = close("dual", dual, fx[f"{p}dual_{k}"],
                                  scale=float(np.abs(fx[f"{p}dual_{k}"]).max()))
                r["admm_misfit"] = close("loss", m["admm_misfit"], want["admm_misfit"],
                                         scale=abs(want["loss"]))
            else:
                e_r = cell_error(problem, p64, state.params, state.colloc)
                cells, carry = hold_cells(k, (z, dual), (fx[f"{p}z_{k}"], fx[f"{p}dual_{k}"]),
                                          e_r, carry, rho)
                r.update(cells)
                # the misfit mean |r - z|: each side's r and z as above
                tol = F64_FACTOR * e_r + cells["z"]["bound"]
                err = abs(m["admm_misfit"] - want["admm_misfit"])
                check(err <= tol, f"step {k}: misfit {m['admm_misfit']} vs JAX "
                      f"{want['admm_misfit']} (bound {tol})")
                r["admm_misfit"] = {"max_abs_err": err, "bound": tol}
        else:
            r["admm_misfit"] = close("loss", m["admm_misfit"], want["admm_misfit"],
                                     scale=abs(want["loss"]))
        if k == 1:
            r["params"] = close_adam_params(flat_np(net_leaves(state.params["net"])),
                                            fx[p + "params_1"], lr)
        rows.append(r)
        k += 1
    return rows, state


def feature_run(card: str, name: str, exp, epochs: int, want_counters, falls: bool = True
                ) -> dict:
    """``exp`` through Trainer.train on the card for ``epochs`` epochs (the
    counts set to 0 just before and read just after, no plain call): the
    launches, wall seconds, the data term (which must fall unless
    ``falls`` is False) and the rel-L2; every counter of ``want_counters``
    must have launched."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.train import trainer as tr

    exp = override(exp, {"train.epochs": epochs, "train.log_every": 0})
    trainer = tr.Trainer(exp, device="cuda")
    state = trainer.init_state()
    data_term = tr.make_data_term(trainer.problem)
    with torch.no_grad():
        loss0 = float(data_term(state.params))
    reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        state, summary = trainer.train(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernel_counts()
    check(plain.calls == 0, f"{name}: {plain.calls} calls of plain versions on the path")
    check(all(launches[c] > 0 for c in want_counters), f"{name}: launches {launches}")
    with torch.no_grad():
        loss1 = float(data_term(state.params))
    rel = {k: v for k, v in summary.items() if k.startswith("rel_l2_")}
    check(all(math.isfinite(v) for v in rel.values()) and math.isfinite(loss1)
          and (loss1 < loss0 or not falls), f"{name}: data term {loss0} -> {loss1}, {rel}")
    emit(card, phase="feature-run", run=name, epochs=epochs, wall_s=wall, data_term=[loss0, loss1],
         **rel, launches=launches, graphed_epochs=launches["generic_chunk_epochs"])
    return {"launches": launches, "wall_s": wall, "summary": summary, "trainer": trainer}


def phase_fourier_train(card: str) -> dict:
    """43: Fourier training and serving on the card. burgers_forward --set
    model.n_fourier=16 from the fixture's JAX state: one step's loss and
    gradient, the 3-step replay, the graphed chunk bit-equal to the
    per-epoch loop, a 2,000-epoch run; euler_admm --set model.n_fourier=16:
    one step against JAX; the JAX-trained Fourier net served through
    predict and HTTP against JAX's outputs; launch-counting runs of the
    other feature modes (Fourier on the Euler trunk, Fourier with paths on
    euler_weak_fast, K1/K2 with paths on burgers_forward)."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.serve import ServedModel, export_predict, make_http_server
    from pinns_tpu_torch.train import trainer as tr

    fx = slice2b_fixture()
    runs, out = {}, {}
    # burgers_forward + Fourier
    exp = override(get_preset("burgers_forward"), FOURIER_UPDATE)
    problem = tr.build_problem(exp, "cuda")
    p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
    spec = problem.spec
    check(spec.fourier == tuple(tuple(r) for r in fx["fb_fourier"].tolist())
          and spec.lb == tuple(fx["fb_lb"]) and spec.ub == tuple(fx["fb_ub"]),
          "burgers_forward + Fourier: spec")
    check(np.array_equal(host(problem.x_data), fx["fb_x_data"]), "the training set differs")
    net = flat_net(fx["fb_params_0"], spec.widths)
    state = fixture_state(problem, net, fx["fb_colloc_0"], problem.device)
    reset_counts()
    loss, grad = kernel_gradient(problem, state, plain=False)
    torch.cuda.synchronize()
    launches = kernel_counts()
    check(launches["taylor2"] == 1 and launches["taylor2_backward"] == 1
          and launches["mlp_forward"] == 1 and launches["mlp_backward"] == 1,
          f"burgers_forward + Fourier: the loss's launches {launches}")
    _, g64 = kernel_gradient(p64, state, plain=True, dtype=torch.float64)
    step_rows = {"loss": close("loss", loss, fx["fb_loss_0"], scale=abs(float(fx["fb_loss_0"]))),
                 "grad_0": close_grad(grad, fx["fb_grad_0"], spec.widths, g64)}
    step = tr.make_step(problem, tr.learning_rate_schedule(exp.optimizer))
    replay, _ = replay_steps(problem, step, state, fx, "fb_", exp.optimizer.learning_rate,
                             fed=False)
    trainer = tr.Trainer(exp, device="cuda")
    run = trainer._get_chunk("adam")
    start = trainer.init_state()
    err = hold_chunk("burgers_forward+fourier", run(start, FEATURE_CHUNK_LEN),
                     tr.run_chunk(trainer._adam_step, start, FEATURE_CHUNK_LEN))
    emit(card, phase="fourier-step", preset="burgers_forward", n_fourier=16, step_0=step_rows,
         launches=launches, replay_steps=len(replay), per_step=replay,
         graphed_chunk_equals_loop=True, chunk_epochs=FEATURE_CHUNK_LEN, chunk_max_abs_err=err)
    out["burgers_grad_err"] = step_rows["grad_0"]["max_abs_err"]
    runs["burgers_fourier"] = feature_run(
        card, "burgers_forward+fourier", exp, FOURIER_TRAIN_EPOCHS,
        ("taylor2", "taylor2_backward", "mlp_forward", "mlp_backward", "generic_chunk_epochs"))
    # euler_admm + Fourier: one step against JAX at the fixture's params
    eexp = override(get_preset("euler_admm"), FOURIER_UPDATE)
    eprob = tr.build_problem(eexp, "cuda")
    e64 = tr.build_problem(override(eexp, {"model.dtype": "float64"}), "cuda")
    check(eprob.spec.layers == tuple(int(w) for w in fx["fe_layers"]), "euler_admm + Fourier")
    check(np.array_equal(host(eprob.x_data), fx["fe_x_data"]), "the Euler training set differs")
    state = fixture_state(eprob, numpy_net(eprob.spec.widths, int(fx["fe_seed"])),
                          fx["fe_colloc_0"], eprob.device, own_admm=True)
    z0 = close("z", np.concatenate([host(c) for c in state.admm.z], 1), fx["fe_z_0"])
    reset_counts()
    loss, grad = kernel_gradient(eprob, state, plain=False)
    torch.cuda.synchronize()
    elaunches = kernel_counts()
    check(elaunches["taylor1"] == 1 and elaunches["taylor1_backward"] == 1
          and elaunches["mlp_forward"] == 1, f"euler_admm + Fourier: launches {elaunches}")
    _, g64 = kernel_gradient(e64, state, plain=True, dtype=torch.float64)
    erows = {"z_0": z0, "loss": close("loss", loss, fx["fe_loss_0"],
                                      scale=abs(float(fx["fe_loss_0"]))),
             "grad_0": close_grad(grad, fx["fe_grad_0"], eprob.spec.widths, g64)}
    emit(card, phase="fourier-step", preset="euler_admm", n_fourier=16, step_0=erows,
         launches=elaunches)
    out["euler_grad_err"] = erows["grad_0"]["max_abs_err"]
    runs["euler_fourier"] = feature_run(
        card, "euler_admm+fourier", eexp, FEATURE_RUN_EPOCHS,
        ("taylor1", "taylor1_backward", "mlp_forward", "mlp_backward"))
    runs["weak_fourier_paths"] = feature_run(
        card, "euler_weak_fast+fourier", override(get_preset(PATH_PRESET), FOURIER_UPDATE),
        FEATURE_RUN_EPOCHS, ("taylor1", "taylor1_backward", "weakform_flux"))
    runs["burgers_paths"] = feature_run(
        card, "burgers_forward+paths", override(get_preset("burgers_forward"),
                                                {"model.n_paths": 2}),
        FEATURE_RUN_EPOCHS, ("taylor2", "taylor2_backward", "mlp_forward"))
    # the JAX-trained Fourier net, served
    lam = fx["fb_served_lambda"]
    with tempfile.TemporaryDirectory() as tmp:
        art = export_predict(spec, flat_net(fx["fb_served_params"], spec.widths),
                             os.path.join(tmp, "jax"), float(lam[0]), float(lam[1]),
                             experiment="burgers_forward")
        served = ServedModel(art, device="cuda")
        check(served.spec == spec, "the served spec")
        x = fx["fb_served_x"]
        reset_counts()
        got = served.predict(x, pad_to_bucket=True)
        served_launches = kernel_counts()
        check(served_launches["taylor2"] == 1, f"served launches {served_launches}")
        vs_jax = {k: compare(k, got[k], fx[f"fb_served_{k}"]) for k in ("u", "f")}
        server = make_http_server(art, port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://127.0.0.1:%d" % server.server_address[1]
            code, _, body = http(base + "/predict", json.dumps({"x": x[:8].tolist()}).encode())
            want8 = served.predict(x[:8], pad_to_bucket=True)
            got8 = {k: np.asarray(v, np.float32) for k, v in json.loads(body).items()}
            check(code == 200 and all(np.array_equal(got8[k], want8[k]) for k in want8),
                  f"HTTP predict answered {code}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "HTTP server thread did not stop")
    emit(card, phase="fourier-serve", preset="burgers_forward", n_fourier=16,
         points=int(x.shape[0]), served_vs_jax=vs_jax, served_launches=served_launches,
         http_points=8)
    out["runs"] = runs
    return out


def phase_flux_admm(card: str) -> dict:
    """44: euler_admm --set loss.admm_form=flux at the trunk: one step from
    the fixture's params (z and the dual on the weak-form cells) and the
    3-step replay against JAX with z and the dual after each step; the
    graphed chunk bit-equal to the per-epoch loop; its L-BFGS phase on
    AutogradLBFGS (K10's kernels around autograd through the loss)."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.train import trainer as tr

    fx = slice2b_fixture()
    exp = override(get_preset("euler_admm"), FLUX_UPDATE)
    problem = tr.build_problem(exp, "cuda")
    p64 = tr.build_problem(override(exp, {"model.dtype": "float64"}), "cuda")
    check(problem.admm_flux and problem.flux, "euler_admm + flux: not the weak-form ADMM")
    check(np.array_equal(host(problem.x_data), fx["fx_x_data"]), "the training set differs")
    state = fixture_state(problem, numpy_net(problem.spec.widths, int(fx["fx_seed"])),
                          fx["fx_colloc_0"], problem.device, own_admm=True)
    z0 = np.concatenate([host(c) for c in state.admm.z], 1)
    with torch.no_grad():
        exact = p64.flux_residuals_and_entropy(
            tr.tree_map(lambda t: t.double(), state.params), state.colloc.double(), plain=True)[0]
    # z_0 = the cells' residual: each side's float32 against float64
    rows = {"z_0": compare_f64("z_0", z0, fx["fx_z_0"],
                               np.concatenate([host(c) for c in exact], 1))}
    reset_counts()
    loss, grad = kernel_gradient(problem, state, plain=False)
    torch.cuda.synchronize()
    launches = kernel_counts()
    # the inviscid cells take K5 at the edge points, the data term K5 again
    check(launches["weakform_flux"] == 1 and launches["weakform_flux_backward"] == 1
          and launches["mlp_forward"] == 2 and launches["mlp_backward"] == 2,
          f"flux ADMM: the loss's launches {launches}")
    _, g64 = kernel_gradient(p64, state, plain=True, dtype=torch.float64)
    rows["loss"] = close("loss", loss, fx["fx_loss_0"], scale=abs(float(fx["fx_loss_0"])))
    rows["grad_0"] = close_grad(grad, fx["fx_grad_0"], problem.spec.widths, g64)
    step = tr.make_step(problem, tr.learning_rate_schedule(exp.optimizer))
    replay, _ = replay_steps(problem, step, state, fx, "fx_", exp.optimizer.learning_rate,
                             fed=True, admm=True, p64=p64)
    trainer = tr.Trainer(exp, device="cuda")
    start = trainer.init_state()
    cells = problem.flux_residuals_and_entropy(start.params, start.colloc)[0]
    check(all(torch.equal(z, c) for z, c in zip(start.admm.z, cells)),
          "the initial z is not the cell residual")
    err = hold_chunk("euler_admm+flux", trainer._get_chunk("adam")(start, FEATURE_CHUNK_LEN),
                     tr.run_chunk(trainer._adam_step, start, FEATURE_CHUNK_LEN))
    lexp = override(exp, {"optimizer.kind": "hybrid", "optimizer.switch_epoch": 0,
                          "optimizer.lbfgs.max_iters": FLUX_LBFGS_ITERS})
    lprob = tr.build_problem(lexp, "cuda")
    lstep = tr.make_lbfgs_step(lprob)
    check(isinstance(lstep.solver, k_lbfgs.AutogradLBFGS),
          f"the flux ADMM's L-BFGS solver is {type(lstep.solver).__name__}")
    loss0 = float(tr.make_loss_fn(lprob)(start.params, start.colloc, start.admm)[0])
    reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        new, m = lstep(start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    llaunches = kernel_counts()
    check(plain.calls == 0, f"{plain.calls} plain calls in the flux ADMM's L-BFGS epoch")
    check(float(m["loss"]) < loss0 and llaunches["lbfgs_control"] > 0
          and llaunches["lbfgs_direction"] > 0 and llaunches["weakform_flux"] > 0,
          f"L-BFGS epoch: loss {loss0} -> {float(m['loss'])}, launches {llaunches}")
    emit(card, phase="flux-admm", preset="euler_admm", admm_form="flux", step_0=rows,
         launches=launches, replay_steps=len(replay), per_step=replay,
         graphed_chunk_equals_loop=True, chunk_epochs=FEATURE_CHUNK_LEN, chunk_max_abs_err=err,
         lbfgs={"solver": "AutogradLBFGS", "max_iters": FLUX_LBFGS_ITERS,
                "iters": float(m["lbfgs_iters"]), "loss": [loss0, float(m["loss"])],
                "wall_s": wall, "launches": llaunches})
    return {"grad_err": rows["grad_0"]["max_abs_err"], "launches": launches}


def phase_rad_swa(card: str) -> dict:
    """45: RAD on abgrall_l2 --set sampling.strategy=rad (8x200) and on
    hwan_admm (ADMM re-initialised): p through the kernels against the plain
    p and JAX's on the fixture's pool, then three chunk boundaries with
    their redraws (each a draw from its pool, the batch fixed inside a
    chunk). SWA on twosin_weak --set train.swa_frac=0.25 over a few chunks:
    the mean against a plain running mean of the same snapshots; train
    --ensemble 3 with SWA: each member's SWA state equal to its solo run's."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.data.sampling import philox_uniform
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.interop import params_from_jax
    from pinns_tpu_torch.ops.kernels.taylor2 import net_leaves
    from pinns_tpu_torch.train import trainer as tr

    fx = slice2b_fixture()
    out = {}
    for preset in ("abgrall_l2", "hwan_admm"):
        p_ = f"rad_{preset}_"
        exp = override(get_preset(preset), {"sampling.strategy": "rad",
                                            "train.chunk": RAD_CHUNK})
        trainer = tr.Trainer(exp, device="cuda")
        problem = trainer.problem
        state = trainer.init_state()
        params = dict(state.params, net=params_from_jax(
            numpy_net(problem.spec.widths, int(fx[p_ + "seed"])), problem.device))
        pool = torch.from_numpy(fx[p_ + "pool"]).cuda()
        with torch.no_grad():
            reset_counts()
            p = tr.rad_probabilities(problem, params, pool)
            torch.cuda.synchronize()
            plaunch = kernel_counts()
            plain = tr.rad_probabilities(problem, params, pool, plain=True)
        check(plaunch["taylor2"] > 0, f"{preset}: p scored off K1 {plaunch}")
        p_rows = {"vs_plain": compare_rtol(f"{preset} p", host(p), host(plain), 1e-5),
                  "vs_jax": compare_rtol(f"{preset} p vs JAX", host(p), fx[p_ + "p"], 1e-5)}
        seen = []
        orig = tr.rad_resample

        def spy(problem_, st, plain_=False):
            new = orig(problem_, st, plain_)
            lb, ub = tr._curriculum_bounds(problem_, int(st.epoch))
            pool_ = philox_uniform(st.key, tr.RAD_POOL + int(st.epoch),
                                   problem_.exp.sampling.rad_pool_factor * new.colloc.shape[0],
                                   lb, ub, torch.float32, "cuda")
            idx = torch.cdist(new.colloc, pool_,
                              compute_mode="donot_use_mm_for_euclid_dist").argmin(dim=1)
            from_pool = float((pool_.index_select(0, idx) - new.colloc).abs().max())
            moved = not torch.equal(new.colloc, st.colloc)
            reinit = None
            if new.admm is not None:
                z = problem_.training_residuals(new.params, new.colloc)
                reinit = bool(torch.equal(new.admm.z, z)
                              and torch.equal(new.admm.dual, torch.ones_like(z)))
            seen.append({"epoch": int(st.epoch), "max_dist_to_pool": from_pool,
                         "moved": moved, "admm_reinit": reinit})
            return new

        tr.rad_resample = spy
        try:
            # hwan_admm's ADMM restarts at every redraw and its data term
            # rises over these 200 epochs, in JAX's trainer too (0.295 ->
            # 0.899 on the CPU)
            run = feature_run(card, f"{preset}+rad", exp, RAD_CHUNK * RAD_CHUNKS,
                              ("taylor2", "taylor2_backward", "philox_draw"),
                              falls=preset != "hwan_admm")
        finally:
            tr.rad_resample = orig
        check([s["epoch"] for s in seen] == [RAD_CHUNK * i for i in range(1, RAD_CHUNKS)]
              and all(s["max_dist_to_pool"] == 0.0 and s["moved"] for s in seen)
              and all(s["admm_reinit"] in (None, True) for s in seen),
              f"{preset}: redraws {seen}")
        # inside a chunk the batch stays: a chunk of the trained state
        st = run["trainer"].init_state()
        st1, _ = run["trainer"]._get_chunk("adam")(st, 3)
        check(torch.equal(st1.colloc, st.colloc), f"{preset}: the batch moved inside a chunk")
        emit(card, phase="rad", preset=preset, p=p_rows, p_launches=plaunch,
             pool=int(pool.shape[0]), redraws=seen, chunk=RAD_CHUNK)
        out[preset] = run
    # SWA
    exp = override(get_preset("twosin_weak"), {"train.swa_frac": SWA_RUN["frac"],
                                               "train.chunk": SWA_RUN["chunk"]})
    snaps = []
    orig = tr.swa_update

    def spy_swa(avg, n, params_):
        snaps.append(tr.tree_map(torch.clone, params_))
        return orig(avg, n, params_)

    tr.swa_update = spy_swa
    try:
        run = feature_run(card, "twosin_weak+swa", exp, SWA_RUN["epochs"],
                          ("weakform_flux", "mlp_forward"))
    finally:
        tr.swa_update = orig
    trainer = run["trainer"]
    want_n = sum(1 for e in range(SWA_RUN["chunk"], SWA_RUN["epochs"] + 1, SWA_RUN["chunk"])
                 if e > SWA_RUN["epochs"] - round(SWA_RUN["frac"] * SWA_RUN["epochs"]))
    check(len(snaps) == want_n == run["summary"]["swa_snapshots"],
          f"SWA snapshots {len(snaps)}, want {want_n}")
    mean = None
    for i, s in enumerate(snaps):  # the plain running mean, leaf by leaf, in float32
        leaves = [t.float() for t in net_leaves(s["net"])]
        # by a device tensor: a true division, as JAX's (ATen multiplies by
        # the reciprocal of a host scalar on the card)
        n = torch.tensor(float(i + 1), device="cuda")
        mean = leaves if mean is None else [a + (x - a) / n for a, x in zip(mean, leaves)]
    swa_err = max(float((a - b).abs().max())
                  for a, b in zip(net_leaves(trainer.swa_params["net"]), mean))
    check(swa_err == 0.0, f"SWA mean differs from the plain running mean by {swa_err}")
    swa_rel = {k: v for k, v in run["summary"].items() if k.startswith("swa_rel_l2")}
    emit(card, phase="swa", preset="twosin_weak", snapshots=len(snaps),
         swa_vs_plain_max_abs_err=swa_err, **swa_rel)
    out["swa"] = run
    # an ensemble with SWA against its members' solo runs, through the CLI
    c = SWA_ENSEMBLE
    common = ["--preset", "twosin_weak", "--device", "cuda", "--epochs", str(c["epochs"]),
              "--set", f"train.swa_frac={c['frac']}", "--set", f"train.chunk={c['chunk']}"]
    with tempfile.TemporaryDirectory() as tmp:
        d = lambda name: os.path.join(tmp, name)  # noqa: E731
        reset_counts()
        rc, lines = cli_lines(["train", *common, "--ensemble", str(c["members"]),
                               "--out-dir", d("ens")])
        launches = kernel_counts()
        check(rc == 0, f"train --ensemble with SWA exited {rc}")
        for i in range(c["members"]):
            rc, _ = cli_lines(["train", *common, "--seed", str(1234 + i), "--out-dir", d(f"s{i}")])
            check(rc == 0, f"solo train exited {rc}")
            for tag in ("swa", "final"):
                check(same_state(d(f"ens/twosin_weak_{tag}_m{i}.ckpt"),
                                 d(f"s{i}/twosin_weak_{tag}.ckpt")),
                      f"member {i}'s {tag} state differs from its solo run")
        emit(card, phase="swa-ensemble", preset="twosin_weak", members=c["members"],
             epochs=c["epochs"], members_equal_solo=True,
             swa_snapshots=[s.get("swa_snapshots") for s in lines[:c["members"]]],
             launches=launches)
    out["swa_ensemble_launches"] = launches
    return out


def compare_rtol(name: str, got, want, rtol: float) -> dict:
    """``got`` within rtol of ``want`` everywhere; raises if not."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape and bool(np.isfinite(got).all()), f"{name}: shape or finite")
    rel = float((np.abs(got - want) / np.abs(want)).max())
    check(rel <= rtol, f"{name}: max relative error {rel} > {rtol}")
    return {"max_rel_err": rel, "max_abs_err": float(np.abs(got - want).max()), "rtol": rtol}


# -- 46 polish: the float64 modes and polish on the card ------------------
POLISH_ITERS = 200  # phase 46's polish from the committed JAX state
POLISH_HELD_ITERS = 20  # its first iterations held to the host loop over the plain loss
POLISH_X_RTOL = 1e-8
F64_RTOL = 1e-12  # the float64 modes against their plain versions
PEAK_FP64 = 34e12  # the H100 SXM's float64 rate outside the tensor cores
K1_F64_N = 10_456  # burgers_forward's batch: 10,000 LHS points and the 456 IC/BC anchors
K5_F64_N = 100  # its data term
K10_F64_M = 50  # optimizer.lbfgs.history


def taylor2_abs_terms(spec, net, x, cot) -> list:
    """Per leaf of K2's gradient, the largest sum over points (and streams)
    of the absolute terms that its sum adds up: the scale against which a
    leaf whose sum cancels is held."""
    from pinns_tpu_torch.models.mlp import embed_streams, normalize_inputs
    from pinns_tpu_torch.ops.kernels.taylor2 import _act_backward
    from pinns_tpu_torch.ops.taylor import _StreamPolicy, taylor2_layer

    pol = _StreamPolicy(spec)
    h = normalize_inputs(spec, x)
    n = x.shape[0]
    streams = embed_streams(spec, h, net[0])
    streams = (h, streams[1].expand(n, -1), streams[2].expand(n, -1), torch.zeros_like(h))
    saved, inputs = [], [streams]
    for i, layer in enumerate(net[:-1]):
        pre, tanh, streams = taylor2_layer(pol, streams, layer["W"], layer["b"], i == 0)
        saved.append((pre, tanh))
        inputs.append(streams)
    out = [None] * (2 * len(net))
    G = tuple(g.reshape(n, -1) for g in cot)
    for l in range(len(net) - 1, -1, -1):
        X = inputs[l]
        out[2 * l] = float(sum(X[s].abs().T @ G[s].abs() for s in range(4)).max())
        out[2 * l + 1] = float(G[0].abs().sum(dim=0).max())
        if l > 0:
            gH = tuple(g @ net[l]["W"].T for g in G)
            G = _act_backward(*saved[l - 1], gH)
    return out


def mlp_abs_terms(net, x, spec, g_out) -> list:
    """The same scale for K5's backward (one stream)."""
    from pinns_tpu_torch.models.mlp import normalize_inputs

    acts = [normalize_inputs(spec, x)]
    for layer in net[:-1]:
        acts.append(torch.tanh(acts[-1] @ layer["W"] + layer["b"]))
    out, g = [None] * (2 * len(net)), g_out
    for l in range(len(net) - 1, -1, -1):
        out[2 * l] = float((acts[l].abs().T @ g.abs()).max())
        out[2 * l + 1] = float(g.abs().sum(dim=0).max())
        if l > 0:
            g = (1.0 - acts[l] * acts[l]) * (g @ net[l]["W"].T)
    return out


def hold_f64(name: str, got, plain, scales=None) -> dict:
    """Each of ``got`` (streams or gradient leaves) within F64_RTOL max|plain|
    of ``plain``; a leaf that misses it and whose sum cancels (max|plain|
    below a hundredth of its sum of absolute terms, ``scales``) within
    F64_RTOL of that sum instead. Raises if any misses."""
    worst, cancelling, max_err = 0.0, [], 0.0
    for i, (a, b) in enumerate(zip(got, plain)):
        a, b = host(a).astype(np.float64), host(b).astype(np.float64)
        check(a.shape == b.shape and bool(np.isfinite(a).all()), f"{name}[{i}]: shape or finite")
        err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
        bnd = F64_RTOL * top
        if err > bnd and scales is not None and top < 1e-2 * scales[i]:
            bnd = F64_RTOL * scales[i]
            cancelling.append(i)
        check(err <= bnd, f"{name}[{i}]: max|kernel - plain| {err} > {bnd}")
        worst, max_err = max(worst, err / max(bnd, 1e-300)), max(max_err, err)
    return {"worst_err_over_bound": worst, "cancelling_leaves": cancelling,
            "max_abs_err": max_err}


def f64_bounds(layers, n_f: int, n_u: int, n: int, m: int) -> dict:
    """(bound_ms, bound_by) of each float64 mode at phase 46's shapes: the
    float64 operations at PEAK_FP64, 8 bytes a value at the memory rate."""
    macs = sum(_macs(layers))
    p = n_params(layers)
    return {
        "taylor2_f64": bound([(4 * 2.0 * macs * n_f, PEAK_FP64)], 16 * n_f + 32 * n_f + 8 * p),
        "taylor2_backward_f64": bound([(3 * 4 * 2.0 * macs * n_f, PEAK_FP64)],
                                      16 * n_f + 32 * n_f + 16 * p),
        "mlp_forward_f64": bound([(2.0 * macs * n_u, PEAK_FP64)], 16 * n_u + 8 * n_u + 8 * p),
        "mlp_backward_f64": bound([(3 * 2.0 * macs * n_u, PEAK_FP64)],
                                  16 * n_u + 8 * n_u + 16 * p),
        # the two-loop over a full history: 2 m dots and axpys; the pairs
        # read once, x and g read, d, xt and g_best written
        "lbfgs_direction_f64": bound([(8.0 * m * n, PEAK_FP64)], 8 * (2 * m * n + 5 * n)),
        # an iteration's end: s, y and their three dots, the history's new
        # pair; x, g, d, g_best read, x, g and the pair written
        "lbfgs_control_f64": bound([(10.0 * n, PEAK_FP64)], 8 * (4 * n + 4 * n)),
        "lbfgs_reset_f64": bound([(0.0, PEAK_FP64)], 8 * 4 * n),
    }


def phase_polish(card: str) -> dict:
    """46: the float64 modes of K1, K2, K5 and K10 against their float64
    plain versions on the card, then ``polish`` from the committed JAX state
    of burgers_forward: its launches (one launch of the solve's WHILE node,
    one read), no host loop, bit for bit the host-stepped AutogradLBFGS over
    the same kernels for POLISH_ITERS iterations, its first iterations
    against the host loop over the plain loss, its loss, its times."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.interop import load_params_npz
    from pinns_tpu_torch.models.mlp import mlp_apply, mlp_apply_reference
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.ops.kernels import mlp_forward as k_mlp
    from pinns_tpu_torch.ops.kernels import taylor2 as k_t2
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference
    from pinns_tpu_torch.opt import lbfgs as lb_mod
    from pinns_tpu_torch.opt.adam import adam_init
    from pinns_tpu_torch.train import trainer as tr
    from pinns_tpu_torch.train.polish import FTOL, GTOL, polish

    dev = torch.device("cuda")
    exp = override(get_preset("burgers_forward"), {"model.dtype": "float64"})
    trainer = tr.Trainer(exp, device="cuda")
    problem = trainer.problem
    spec = problem.spec
    check(spec.dtype == torch.float64 and spec.layers == NARROW, f"polish spec {spec}")
    loaded = load_params_npz(FIXTURE)
    net = [{k: torch.as_tensor(np.asarray(v), dtype=torch.float64).to(dev).contiguous()
            for k, v in layer.items()} for layer in loaded["params"]]
    params = {"net": net, "coeffs": {
        "lambda1": torch.full((1,), exp.pde.lambda1, dtype=torch.float64, device=dev),
        "lambda2": torch.full((1,), exp.pde.lambda2, dtype=torch.float64, device=dev)}}
    colloc = tr.init_collocation(problem, exp.train.seed)
    check(colloc.dtype == torch.float64 and colloc.shape[0] == K1_F64_N, "the f64 batch")
    state = tr.TrainState(params=params, opt_state=adam_init(params), admm=None, colloc=colloc,
                          key=exp.train.seed, epoch=int(loaded.get("epochs") or 0))
    rng = np.random.default_rng(46)
    out = {"kernels": {}, "times": {}}

    # -- K1 and K2's float64 modes at 8x20, N 10,000 (the batch itself)
    cot = [torch.from_numpy(rng.standard_normal((K1_F64_N, 1))).to(dev) for _ in range(4)]
    with torch.no_grad():
        got = k_t2.taylor2(spec, net, colloc)
        again = k_t2.taylor2(spec, net, colloc)
        plain = mlp_taylor_2_reference(spec, net, colloc)
        g_k2 = k_t2.taylor2_backward(spec, net, colloc, cot)
        g_k2b = k_t2.taylor2_backward(spec, net, colloc, cot)
        g_plain = k_t2.taylor2_backward_reference(spec, net, colloc, cot)
        scales = taylor2_abs_terms(spec, net, colloc, cot)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "two K1 f64 calls differ")
    check(torch.equal(g_k2, g_k2b), "two K2 f64 calls differ")
    leaves = k_t2.split_grad(g_k2, k_t2.net_leaves(net))
    out["kernels"]["taylor2_f64"] = hold_f64("K1 f64", got, plain)
    out["kernels"]["taylor2_backward_f64"] = hold_f64("K2 f64", leaves, g_plain, scales)

    # -- K5's float64 mode at N 100 (the data term's shape)
    xu = problem.x_data
    check(xu.shape[0] == K5_F64_N and xu.dtype == torch.float64, "the f64 data points")
    g_out = torch.from_numpy(rng.standard_normal((K5_F64_N, 1))).to(dev)
    with torch.no_grad():
        u = k_mlp.mlp_forward(spec, net, xu)
        u2 = k_mlp.mlp_forward(spec, net, xu)
        u_plain = mlp_apply_reference(spec, net, xu)
        g5 = k_mlp.mlp_backward(spec, net, xu, g_out)
        g5b = k_mlp.mlp_backward(spec, net, xu, g_out)
        g5_plain = k_mlp.mlp_backward_reference(spec, net, xu, g_out)
        scales5 = mlp_abs_terms(net, xu, spec, g_out)
    torch.cuda.synchronize()
    check(torch.equal(u, u2) and torch.equal(g5, g5b), "two K5 f64 calls differ")
    out["kernels"]["mlp_forward_f64"] = hold_f64("K5 f64 forward", [u], [u_plain])
    out["kernels"]["mlp_backward_f64"] = hold_f64(
        "K5 f64 backward", k_t2.split_grad(g5, k_t2.net_leaves(net)), g5_plain, scales5)

    # -- K10's float64 mode: a seeded full history (streamed layout), each
    # kernel bit for bit against its plain version
    x0, unravel = lb_mod.ravel_tree(params)
    n = x0.numel()
    plan = k_lbfgs.cluster_plan(n, K10_F64_M, 8)
    check(not plan.resident, f"the float64 pairs at n {n} should be streamed: {plan}")

    def same(b, twin, what):
        for name, a, c in zip(("si", "sf", "vec", "hist", "rho"), b.tensors(), twin.tensors()):
            check(torch.equal(a, c), f"K10 f64 {what} differs from its plain version in {name}")

    seeded = k_lbfgs.seeded_state(n, K10_F64_M, K10_F64_M, 9, seed=46, device="cuda",
                                  dtype=torch.float64)
    b, twin = seeded.clone(), seeded.clone()
    k_lbfgs.direction(b)
    k_lbfgs.direction_reference(twin)
    torch.cuda.synchronize()
    same(b, twin, "direction (seeded)")
    b.vec[k_lbfgs.GT].copy_(torch.from_numpy(rng.standard_normal(n)).to(dev))
    b.sf[k_lbfgs.F_PHI_T] = 0.5
    twin = b.clone()
    after_dir = b.clone()
    k_lbfgs.control(b)
    k_lbfgs.control_reference(twin)
    torch.cuda.synchronize()
    same(b, twin, "control (seeded)")

    # the first POLISH_HELD_ITERS iterations of the real polish, launch by
    # launch against the plain versions, the kernels' loss as the evaluation
    loss_fn = tr.make_loss_fn(problem)
    fun = lambda x: loss_fn(unravel(x), colloc, None)[0]  # noqa: E731
    solver = k_lbfgs.AutogradLBFGS()
    cfg = exp.optimizer.lbfgs
    b = k_lbfgs.Buffers.alloc(n, cfg.history, "cuda", torch.float64)
    solver.bufs = b
    twin = b.clone()
    k_lbfgs.reset(b, x0.detach().contiguous(), max_iters=POLISH_HELD_ITERS, max_ls=cfg.max_ls,
                  ftol=FTOL, gtol=GTOL)
    k_lbfgs.reset_reference(twin, x0.detach(), POLISH_HELD_ITERS, cfg.max_ls,
                            k_lbfgs.solve_constants(ftol=FTOL, gtol=GTOL, dtype=np.float64))
    torch.cuda.synchronize()
    same(b, twin, "reset")
    steps = 0
    while not int(b.si[k_lbfgs.I_DONE]):
        solver._evaluate(fun)
        for which, kernel, ref in (("control", k_lbfgs.control, k_lbfgs.control_reference),
                                   ("direction", k_lbfgs.direction, k_lbfgs.direction_reference)):
            twin = b.clone()
            kernel(b)
            ref(twin)
            torch.cuda.synchronize()
            same(b, twin, f"{which} at step {steps}")
        steps += 1
    lockstep = k_lbfgs.result(b, k_lbfgs.read_head(b))
    for name in ("lbfgs_control_f64", "lbfgs_direction_f64", "lbfgs_reset_f64"):
        out["kernels"][name] = {"max_abs_err": 0.0, "steps": steps}

    # -- polish on the card: the launches, no host loop, no plain version
    f0 = float(fun(x0))
    reset_counts()
    with PlainCalls() as plain_calls:
        t0 = time.perf_counter()
        polished, res = polish(problem, state, POLISH_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernel_counts()
    check(plain_calls.calls == 0, f"polish called a plain version {plain_calls.calls} times")
    for name in ("taylor2_f64", "taylor2_backward_f64", "mlp_forward_f64", "mlp_backward_f64",
                 "lbfgs_reset_f64", "lbfgs_control_f64", "lbfgs_direction_f64"):
        check(counts[name] > 0, f"polish launched no {name}")
    check(counts["lbfgs_host_syncs"] == counts["lbfgs_loop_launches"] == 1
          and counts["lbfgs_control_f64"] == counts["lbfgs_loop_steps"]
          and counts["lbfgs_steps_after_end"] < k_lbfgs.AUTOGRAD_STEPS,
          f"polish's loop launches, steps and host syncs: {counts}")
    for name in ("taylor2", "taylor2_backward", "mlp_forward", "mlp_backward", "lbfgs_control",
                 "lbfgs_direction", "fused_step", "fused_value_and_grad"):
        check(counts[name] == 0, f"polish launched the float32 {name}")
    check(float(res.f) <= f0, f"the polished loss {float(res.f)} is above the start's {f0}")
    _, again = polish(problem, state, POLISH_ITERS)
    check(torch.equal(again.x, res.x) and again.n_iters == res.n_iters,
          "two polishes on the card differ")
    # the captured polish against the host-stepped one over the same kernels
    captured, stepped = k_lbfgs.AutogradLBFGS(), k_lbfgs.AutogradLBFGS(captured=False)
    popts = dict(max_iters=POLISH_ITERS, history=cfg.history, ftol=FTOL, gtol=GTOL)
    cap, hs = captured.minimize(fun, x0.detach(), **popts), stepped.minimize(fun, x0.detach(),
                                                                             **popts)
    check(torch.equal(cap.x, hs.x) and torch.equal(cap.f, hs.f) and torch.equal(cap.g, hs.g)
          and (cap.n_iters, cap.n_evals) == (hs.n_iters, hs.n_evals)
          and int(captured.bufs.si[k_lbfgs.I_BRANCHES]) == int(stepped.bufs.si[k_lbfgs.I_BRANCHES])
          and torch.equal(cap.x, res.x),
          f"the captured polish ({cap.n_iters}, {cap.n_evals}) differs from the host-stepped "
          f"one ({hs.n_iters}, {hs.n_evals}) or from polish")

    # -- its first iterations against the host loop over the plain loss
    head, _ = polish(problem, state, POLISH_HELD_ITERS)
    head_x = lb_mod.ravel_tree(head.params)[0]
    plain_loss = tr.make_loss_fn(problem, plain=True)
    host_res = lb_mod.lbfgs_minimize(
        lambda x: plain_loss(unravel(x), colloc, None)[0], x0.detach(),
        max_iters=POLISH_HELD_ITERS, history=cfg.history, ftol=FTOL, gtol=GTOL,
        max_ls=cfg.max_ls)
    x_err = float((head_x - host_res.x).abs().max())
    x_bnd = POLISH_X_RTOL * float(host_res.x.abs().max())
    check(torch.equal(head_x, lockstep.x), "the polish differs from its lockstep")
    check(host_res.n_iters == lockstep.n_iters,
          f"n_iters {lockstep.n_iters} != the host loop's {host_res.n_iters}")
    check(x_err <= x_bnd, f"x after {POLISH_HELD_ITERS} iterations: {x_err} > {x_bnd}")
    ev0, ev1 = trainer.evaluate(state), trainer.evaluate(polished)

    # -- times: the polish (wall, device, launches, syncs an iteration) and
    # each float64 mode against its plain version (CUDA events, in turns)
    it = max(res.n_iters, 1)
    dev = device_fields(lambda: polish(problem, state, POLISH_ITERS), it, 1e3 * wall,
                        captured=True)
    out["polish"] = {
        "iters": res.n_iters, "evals": res.n_evals, "converged": res.converged,
        "loss_start": f0, "loss_end": float(res.f), "wall_s": wall,
        "ms_per_iter": 1e3 * wall / it,
        "device_ms_per_iter": 1e-3 * dev["device_us_per_iter"], "device_clock": dev["device_clock"],
        "host_syncs_per_iter": counts["lbfgs_host_syncs"] / it,
        "steps_per_body": k_lbfgs.AUTOGRAD_STEPS, "loop_steps": counts["lbfgs_loop_steps"],
        "steps_after_end": counts["lbfgs_steps_after_end"],
        "captured_vs_host_stepped": {"iters": cap.n_iters, "evals": cap.n_evals,
                                     "bit_equal": True},
        "idle_share": dev["idle_share"],
        "rel_l2_u_start": ev0["rel_l2_u"], "rel_l2_u_end": ev1["rel_l2_u"],
        "held": {"iters": POLISH_HELD_ITERS, "n_iters": lockstep.n_iters,
                 "n_evals": [lockstep.n_evals, host_res.n_evals], "x_err": x_err,
                 "x_bound": x_bnd},
    }
    out["launches"] = counts
    t = out["times"]
    with torch.no_grad():
        t["taylor2_f64"] = event_ms_turns(
            [lambda: k_t2.taylor2(spec, net, colloc),
             lambda: mlp_taylor_2_reference(spec, net, colloc)], REPS)
        t["taylor2_backward_f64"] = event_ms_turns(
            [lambda: k_t2.taylor2_backward(spec, net, colloc, cot),
             lambda: k_t2.taylor2_backward_reference(spec, net, colloc, cot)], REPS)
        t["mlp_forward_f64"] = event_ms_turns(
            [lambda: k_mlp.mlp_forward(spec, net, xu),
             lambda: mlp_apply_reference(spec, net, xu)], REPS)
        t["mlp_backward_f64"] = event_ms_turns(
            [lambda: k_mlp.mlp_backward(spec, net, xu, g_out),
             lambda: k_mlp.mlp_backward_reference(spec, net, xu, g_out)], REPS)
    # K10: each launch from a restored state (the seeded full history), the
    # restore's own time taken off
    work = seeded.clone()

    def restore(src):
        for a, c in zip((work.si, work.sf, work.vec, work.rho), (src.si, src.sf, src.vec,
                                                                 src.rho)):
            a.copy_(c)

    def k10_ms(src, kernel):
        both = event_ms_turns([lambda: (restore(src), kernel(work)), lambda: restore(src)], REPS)
        return max(0.0, both[0] - both[1])

    work.hist.copy_(seeded.hist)
    x_seed = seeded.vec[k_lbfgs.X].clone()
    t["lbfgs_direction_f64"] = [k10_ms(seeded, k_lbfgs.direction),
                                k10_ms(seeded, k_lbfgs.direction_reference)]
    t["lbfgs_control_f64"] = [k10_ms(after_dir, k_lbfgs.control),
                              k10_ms(after_dir, k_lbfgs.control_reference)]
    reset_kw = dict(max_iters=10, max_ls=50, ftol=FTOL, gtol=GTOL)
    consts = k_lbfgs.solve_constants(ftol=FTOL, gtol=GTOL, dtype=np.float64)
    t["lbfgs_reset_f64"] = event_ms_turns(
        [lambda: k_lbfgs.reset(work, x_seed, **reset_kw),
         lambda: k_lbfgs.reset_reference(work, x_seed, 10, 50, consts)], REPS)
    out["bounds"] = f64_bounds(NARROW, K1_F64_N, K5_F64_N, n, K10_F64_M)
    emit(card, phase="polish", spec=str(spec.layers), n_params=n, plan=dataclasses.asdict(plan),
         kernels=out["kernels"], polish=out["polish"], launches=counts,
         times_ms={k: list(v) for k, v in t.items()},
         bounds={k: list(v) for k, v in out["bounds"].items()},
         criterion=f"max|kernel - plain| <= {F64_RTOL} max|plain| (a cancelling leaf: of its "
                   "sum of absolute terms); K10 bit for bit; two calls bit-equal")
    return out


# -- 47 dp: slice 6, data parallelism over NCCL (scripts/dp_smoke.py) ----------
DP_TIMEOUT = 600  # seconds for the torchrun call (about 60 s at one card)


def phase_dp(card: str) -> dict:
    """scripts/dp_smoke.py under torchrun, one process a card of this
    machine; the result object it writes. The launcher runs in a session of
    its own, killed with its workers if it outlives DP_TIMEOUT."""
    import signal
    import socket

    n = torch.cuda.device_count()
    # the ranks are other processes on these cards: hand back this one's cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dp_smoke.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
               "--master-port", str(port), os.path.join(ROOT, "scripts", "dp_smoke.py"),
               "--out", out]
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            log, _ = proc.communicate()
            raise RuntimeError(f"chip_smoke: dp_smoke outlived {DP_TIMEOUT} s:\n{log[-4000:]}")
        check(proc.returncode == 0, f"dp_smoke failed ({proc.returncode}):\n{log[-6000:]}")
        with open(out) as fh:
            res = json.load(fh)
    check(res["world"] == n, f"dp_smoke ran {res['world']} ranks on {n} cards")
    emit(card, phase="dp", world=n, modes=res["modes"], draws=res["draws"],
         main={k: v for k, v in res["main"].items() if k != "phase_s"},
         generic=res["generic"], scale=res["scale"], ensemble=res["ensemble"],
         multi_gpu=n > 1, note=None if n > 1 else "one card: not multi-GPU evidence")
    return res


def dp_entries(dp: dict) -> list:
    """The kernels line's entries of K3's data-parallel modes (phase 47):
    launches from the data-parallel main path, the narrow design's error,
    times and bounds, and the wide design's beside them."""
    out = []
    for mode in ("reduce", "apply"):
        narrow, wide = dp["modes"]["narrow_8x20"], dp["modes"]["wide_8x200"]
        out.append({
            "name": f"fused_step_dp_{mode}",
            "route": "cuda",
            "source": "pinns_tpu_torch/csrc/fused_step.cu",
            "replaces": "3266821^:pinns_tpu/ops/pallas/fused_step.py:304",
            "launches": dp["main"]["counts"][f"dp_{mode}"],
            "max_abs_err": narrow[f"{mode}_max_abs_err"],
            "ms": narrow[f"{mode}_ms"],
            "plain_ms": narrow[f"{mode}_plain_ms"],
            **bound_fields(narrow[f"{mode}_bound"]),
            "ranks": dp["world"],
            "rows_per_rank": narrow["n_local"],
            "wide_8x200": {"max_abs_err": wide[f"{mode}_max_abs_err"],
                           "ms": wide[f"{mode}_ms"], "plain_ms": wide[f"{mode}_plain_ms"],
                           **bound_fields(wide[f"{mode}_bound"])},
        })
    return out


# -- 48 generators: slice 7, the data generators on K12 ------------------------
# the Burgers grids on the card against the JAX package's committed float32
# grids (tests/fixtures/torch_port/<key>.npz): the two differ by float32
# rounding in other places (the grid points, XLA's CPU arithmetic against
# ATen's reciprocal divisions), 1.3e-5 and 5.7e-5 of max|JAX| on the CPU
# (tests/test_torch_generator_grids.py holds them by the float64 criterion);
# 1e-3 is far below the grids' own 1.4% / 1.7% identification error against
# the stored reference grids
FV_JAX_TOL = 1e-3
# the Euler solve's rho and u rel-L2 against the exact Riemann solution at
# its snapshots before t = 0.2 (the waves still inside [0, 1]): MUSCL's
# smearing of the shock, the contact and the fan, 0.7-0.9% in rho and up to
# 8.9% in u at the earliest snapshots, where the fan is a few cells wide
# (the plain version on the CPU)
FV_EULER_BAND = 0.1
# the float operations of a cell a stage (a division or square root one
# operation, so a lower bound): the viscous Burgers stage (slopes 10, face
# 13, update and viscosity 12, combine 4) and the Euler stage (slopes 30,
# faces 12 + 2 x (velocity and pressure 5, speed 6, flux 4) + 17, update 15)
FV_FLOPS = {"burgers": 39, "euler": 104}
GENERATE_KINDS = {  # generate-data kind -> (the .mat's keys, the fields' (nx, nt))
    "burgers_shock": (("t", "usol", "x"), (256, 100)),
    "burgers_twosin": (("t", "usol", "x"), (513, 101)),
    "twosin_dataset": (("t", "usol", "x"), (513, 101)),
    "abgrall_dataset": (("t", "usol", "x"), (257, 257)),
    "euler_dataset": (("Enersol", "rhosol", "t", "usol", "x"), (300, 157)),
    "euler": (("Enersol", "rhosol", "t", "usol", "x"), (1500, 157)),
}
FV_GRIDS = {"twosin": "twosin_burgers_shock", "abgrall": "abgrall_burgers_shock"}
# the euler kind of generate-data at its native size and t_final 1.0
FV_EULER = {"nx": 1500, "t_final": 1.0, "n_snapshots": 157}


def fv_solves() -> dict:
    """The three solves of phase 48 as K12 takes them on the card: name ->
    (mode, plan, nu, periodic), from the arguments make_twosin_grid and
    make_abgrall_burgers_grid pass (generators.twosin_fv_args,
    abgrall_fv_args) and FV_EULER."""
    from pinns_tpu_torch.data import generators as g

    out = {}
    for name, args in (("twosin", g.twosin_fv_args()), ("abgrall", g.abgrall_fv_args())):
        out[name] = ("burgers", g.burgers_plan(**args, device="cuda"), args["nu"],
                     args["periodic"])
    out["euler"] = ("euler", g.euler_plan(**FV_EULER, device="cuda"), 0.0, False)
    return out


def fv_call(mode: str, plan, nu: float, periodic: bool, plain: bool = False):
    from pinns_tpu_torch.ops.kernels import fv_solve

    if mode == "euler":
        fn = fv_solve.euler_trajectory_reference if plain else fv_solve.euler_trajectory
        return fn(plan.q0, plan.dx, plan.dt, plan.steps_per_snap, plan.n_snap)
    fn = fv_solve.burgers_trajectory_reference if plain else fv_solve.burgers_trajectory
    return fn(plan.q0, plan.dx, plan.dt, plan.steps_per_snap, plan.n_snap, nu, periodic,
              plan.offset_steps)


def fv_bound(mode: str, plan):
    """K12's bound for one solve: its stages' operations over the fp32 peak,
    or the initial state read and the snapshots written over HBM, the
    larger. The real floor of a one-CTA solve is its chain of dependent
    stages, far above either."""
    stages = 3 * (plan.steps_per_snap * (plan.n_snap - 1) + plan.offset_steps)
    cells = plan.q0.numel()  # Euler: 3 components a cell
    n = plan.q0.shape[0]
    return bound([(stages * n * FV_FLOPS[mode], PEAK_FP32)], 4 * cells * (1 + plan.n_snap))


def fv_time(fn) -> tuple:
    """(milliseconds of one call by CUDA events, its result)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def native_loads() -> dict:
    """Each dataset key through the loader with no reference tree and an
    empty grid directory, on the card: key -> GridDataset (generated
    natively)."""
    from pinns_tpu_torch.data import datasets as tds

    saved_dir, saved_root = tds.GRID_DIR, os.environ.pop("PINNS_TPU_DATA_ROOT", None)
    try:
        with tempfile.TemporaryDirectory() as empty:
            tds.GRID_DIR = type(saved_dir)(empty)
            out = {key: tds.load_burgers_mat(key, "cuda") for key in tds.BURGERS_DATASETS}
            out.update({key: tds.load_euler_mat(key) for key in tds.EULER_DATASETS})
    finally:
        tds.GRID_DIR = saved_dir
        if saved_root is not None:
            os.environ["PINNS_TPU_DATA_ROOT"] = saved_root
    return out


def phase_generators(card: str) -> dict:
    """48: the main path on the card (the three solves through the public
    functions and the loader's native fallback), counted; generate-data for
    every kind; then K12 against its plain version on the card, timed."""
    import scipy.io

    from pinns_tpu_torch.data import generators as g

    reset_counts()
    t0 = time.perf_counter()
    grids = {"twosin": g.make_twosin_grid(device="cuda"),
             "abgrall": g.make_abgrall_burgers_grid(device="cuda")}
    t_grids = time.perf_counter() - t0
    euler = g.euler_solve(**FV_EULER, device="cuda")
    t_euler = time.perf_counter() - t0 - t_grids
    loads = native_loads()
    counts = kernel_counts()
    launches = {"fv_burgers": counts["fv_burgers"], "fv_euler": counts["fv_euler"]}
    check(launches == {"fv_burgers": 4, "fv_euler": 1},
          f"K12 launches on the main path: {launches} (2 grids + 2 native loads, 1 Euler solve)")
    rows = {}
    for name, key in FV_GRIDS.items():
        with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port", f"{key}.npz")) as z:
            want = np.asarray(z["usol"], np.float64)
        got = grids[name]["usol"]
        check(got.shape == want.shape and bool(np.isfinite(got).all()), f"{name}: {got.shape}")
        err = float(np.abs(got - want).max() / np.abs(want).max())
        check(err <= FV_JAX_TOL, f"{name}: max|card - JAX| {err} of max|JAX| > {FV_JAX_TOL}")
        ds = loads[key]
        check(ds.provenance == "native" and np.array_equal(ds.fields["u"],
                                                         got.T.astype(np.float32)),
              f"the loader's native {key} is not make_*_grid's")
        rows[name] = {"rel_max_err_vs_jax": err}
    for key in ("burgers_shock", "abgrall_eulers"):
        check(loads[key].provenance == "native", f"{key}: {loads[key].provenance}")
    left, right = g.blend_primitives()
    x, t = euler["x"].ravel().astype(np.float64), euler["t"].ravel()
    nx, nt = FV_EULER["nx"], FV_EULER["n_snapshots"]
    check(euler["rhosol"].shape == (nx, nt) and all(
        bool(np.isfinite(euler[k]).all()) for k in ("rhosol", "usol", "Enersol")), "euler")
    early = []
    for k in range(1, nt):
        if t[k] > 0.2:
            break
        w = g.euler_exact_riemann(x, float(t[k]), left, right)
        early.append(max(np.linalg.norm(euler["rhosol"][:, k] - w[:, 0]) / np.linalg.norm(w[:, 0]),
                         np.linalg.norm(euler["usol"][:, k] - w[:, 1]) / np.linalg.norm(w[:, 1])))
    check(max(early) <= FV_EULER_BAND, f"euler vs exact Riemann: {max(early)}")
    rows["euler"] = {"max_rel_l2_vs_exact_t_le_0.2": max(early), "snapshots": len(early)}

    # generate-data, each kind in a process of its own, all started together
    gen = {}
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        procs = {kind: subprocess.Popen(
            [sys.executable, "-m", "pinns_tpu_torch", "generate-data", "--kind", kind,
             "--out", os.path.join(tmp, f"{kind}.mat")], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for kind in GENERATE_KINDS}
        try:
            logs = {kind: proc.communicate(timeout=600) for kind, proc in procs.items()}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
        gen["all_kinds_s"] = round(time.perf_counter() - t1, 2)
        for kind, (keys, shape) in GENERATE_KINDS.items():
            check(procs[kind].returncode == 0, f"generate-data {kind}: {logs[kind][1][-3000:]}")
            mat = scipy.io.loadmat(os.path.join(tmp, f"{kind}.mat"))
            check(tuple(sorted(k for k in mat if not k.startswith("__"))) == keys,
                  f"generate-data {kind}: keys {sorted(mat)}")
            field = "rhosol" if "rhosol" in keys else "usol"
            check(mat[field].shape == shape and mat["x"].shape == (shape[0], 1)
                  and mat["t"].shape == (shape[1], 1), f"generate-data {kind}: {mat[field].shape}")
            same = {"twosin_dataset": grids["twosin"], "abgrall_dataset": grids["abgrall"],
                    "euler": euler}.get(kind)
            if same is not None:  # the same K12 solve in another process
                check(all(np.array_equal(mat[k], same[k]) for k in keys if k in same),
                      f"generate-data {kind} differs from the in-process grid")

    # K12 against its plain version on the card; times
    kernels = {}
    for name, (mode, plan, nu, periodic) in fv_solves().items():
        a = fv_call(mode, plan, nu, periodic)
        b = fv_call(mode, plan, nu, periodic)
        plain_ms, ref = fv_time(lambda: fv_call(mode, plan, nu, periodic, plain=True))
        check(torch.equal(a, b), f"K12 {name}: two calls differ")
        check(torch.equal(a, ref), f"K12 {name} != plain: {float((a - ref).abs().max())}")
        ms = statistics.median(fv_time(lambda: fv_call(mode, plan, nu, periodic))[0]
                               for _ in range(3))
        kernels[name] = {"mode": mode, "cells": int(plan.q0.shape[0]),
                         "steps_per_snap": plan.steps_per_snap, "snapshots": plan.n_snap,
                         "pre_steps": plan.offset_steps,
                         "steps": plan.steps_per_snap * (plan.n_snap - 1) + plan.offset_steps,
                         "ms": ms, "plain_ms": plain_ms, "bound": fv_bound(mode, plan),
                         "max_abs_err": float((a - ref).abs().max())}
    emit(card, phase="generators", launches=launches, grids=rows, generate_data_s=gen,
         main_path_s={"grids": t_grids, "euler": t_euler}, k12=kernels,
         criterion="K12 == plain (torch.equal) and two K12 calls equal; grids vs JAX "
                   f"<= {FV_JAX_TOL} max|JAX|; euler vs exact <= {FV_EULER_BAND}")
    return {"launches": launches, "kernels": kernels}


def fv_entries(gen: dict) -> list:
    """The kernels line's entries of K12's two modes (phase 48): launches from
    the main path, the error against the plain version (bit for bit), times
    and bounds of one full-size solve (fv_burgers: make_twosin_grid's, with
    make_abgrall_burgers_grid's beside it)."""
    k = gen["kernels"]

    def entry(name, solve, extra):
        row = k[solve]
        return {"name": name, "route": "cuda", "source": "pinns_tpu_torch/csrc/fv_solve.cu",
                "replaces": "pinns_tpu/data/generators.py:" + ("141" if solve == "euler" else "205"),
                "launches": gen["launches"][name], "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"], **bound_fields(row["bound"]),
                "unit": "ms a solve", "cells": row["cells"], "steps": row["steps"], **extra}

    abg = k["abgrall"]
    return [entry("fv_burgers", "twosin", {"abgrall": {
                "ms": abg["ms"], "plain_ms": abg["plain_ms"], **bound_fields(abg["bound"]),
                "cells": abg["cells"], "steps": abg["steps"]}}),
            entry("fv_euler", "euler", {})]


# -- 49: burgers_inverse's L-BFGS outer epoch, captured into K10's loop --------

INVERSE_ADAM = 500  # the short Adam state phase 49 starts from (K9's generic runner)
INVERSE_MAX_ITERS = 300  # the outer epoch's iterations, held and timed
INVERSE_TURNS = 3  # alternating outer epochs a side for the times


def outer_epoch_times(steps: dict, state, turns: int) -> dict:
    """Each L-BFGS outer epoch ``step`` of ``steps`` from ``state``, ``turns``
    times in turns: ms an iteration (host clock, median), its iterations and
    the host syncs of the last call; the device time and idle share of one
    more call (:func:`device_fields`: a captured solver's by CUDA events
    around its loop, another's by the profiler, with its launches)."""
    walls = {name: [] for name in steps}
    runs = {}
    for fn in steps.values():  # the first call captures or warms up
        fn(state)
    for _ in range(turns):
        for name, fn in steps.items():
            runs[name] = timed_outer(fn, state, 1)
            walls[name] += runs[name]["wall_ms"]
    out = {}
    for name, fn in steps.items():
        it = max(1, runs[name]["n_iters"])
        wall = statistics.median(walls[name])
        out[name] = {
            "ms_per_iter": wall / it, "wall_ms": walls[name], "n_iters": runs[name]["n_iters"],
            "host_syncs": runs[name]["syncs"], "syncs_per_iter": runs[name]["syncs"] / it,
            **device_fields(lambda: fn(state), it, wall,
                            captured=getattr(fn.solver, "captured", False))}
    return out


def phase_inverse_lbfgs(card: str) -> dict:
    """49: burgers_inverse's L-BFGS phase on the card (AutogradLBFGS: autograd
    through K1, K2 and K5 with the exp coefficient's gradient as the
    evaluation) from INVERSE_ADAM Adam epochs of Trainer.train: one outer
    epoch of up to INVERSE_MAX_ITERS iterations captured into the solve's
    WHILE node (one launch, one read) against the same solver host-stepped
    (the flag read every 16 steps): the params, the loss, the iterations and
    the branches bit for bit; then both timed in turns, with each side's
    host syncs and device time (:func:`device_fields`)."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset
    from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs
    from pinns_tpu_torch.opt import lbfgs as lb_mod
    from pinns_tpu_torch.train import trainer as tr

    exp = override(get_preset("burgers_inverse"), {
        "train.log_every": 0, "optimizer.lbfgs.max_iters": INVERSE_MAX_ITERS})
    trainer = tr.Trainer(exp, device="cuda")
    state, _ = trainer.train(epochs=INVERSE_ADAM)
    check(state.epoch == INVERSE_ADAM, f"the Adam state's epoch {state.epoch}")
    steps = {"k10": tr.make_lbfgs_step(trainer.problem),
             "k10_host_stepped": tr.make_lbfgs_step(trainer.problem)}
    steps["k10_host_stepped"].solver.captured = False
    check(all(isinstance(s.solver, k_lbfgs.AutogradLBFGS) for s in steps.values())
          and steps["k10"].solver.captured, "burgers_inverse's L-BFGS solver")
    reset_counts()
    with PlainCalls() as plain:
        news = {name: fn(state) for name, fn in steps.items()}
    counts = kernel_counts()
    check(plain.calls == 0, f"{plain.calls} calls of a plain version in the outer epochs")
    (a, ma), (b, mb) = news["k10"], news["k10_host_stepped"]
    sa, sb = (s.solver.bufs for s in steps.values())
    check(torch.equal(lb_mod.ravel_tree(a.params)[0], lb_mod.ravel_tree(b.params)[0])
          and torch.equal(ma["loss"], mb["loss"]) and float(ma["lbfgs_iters"]) ==
          float(mb["lbfgs_iters"]) and torch.equal(sa.vec[k_lbfgs.G], sb.vec[k_lbfgs.G])
          and int(sa.si[k_lbfgs.I_EVALS]) == int(sb.si[k_lbfgs.I_EVALS])
          and int(sa.si[k_lbfgs.I_BRANCHES]) == int(sb.si[k_lbfgs.I_BRANCHES]),
          "the captured outer epoch differs from the host-stepped one")
    check(counts["lbfgs_loop_launches"] == 1 and counts["lbfgs_solves"] == 2
          and all(counts[k] > 0 for k in ("taylor2", "taylor2_backward", "mlp_forward",
                                          "mlp_backward")),
          f"the outer epochs' launches {counts}")
    lam = dict(zip(("lambda1", "lambda2"),
                   (float(v) for v in trainer.problem.effective_coeffs(a.params))))
    times = outer_epoch_times(steps, state, INVERSE_TURNS)
    check(times["k10"]["host_syncs"] == 1, f"the captured outer epoch's host syncs {times}")
    times["k10"].update(steps_per_body=steps["k10"].solver.steps,
                        capture_s=steps["k10"].solver.capture_seconds[-1])
    emit(card, phase="inverse-lbfgs", preset="burgers_inverse", adam_epochs=INVERSE_ADAM,
         max_iters=INVERSE_MAX_ITERS, n_iters=int(float(ma["lbfgs_iters"])),
         n_evals=int(sa.si[k_lbfgs.I_EVALS]), branches=k_lbfgs.branches_taken(sa),
         loss=float(ma["loss"]), coeffs=lam, bit_equal=True, times=times,
         launches={k: v for k, v in counts.items() if v},
         clock="host for the outer epochs; device: CUDA events around the captured loop, "
               "the profiler for the host-stepped drive")
    return {"times": times, "launches": counts}


def main() -> int:
    # -- 1 device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pinns_tpu_torch.device import resolve_device
    from pinns_tpu_torch.interop import load_params_npz, params_from_jax
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels import build
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference
    from pinns_tpu_torch.serve import ServedModel, export_predict, make_http_server
    from pinns_tpu_torch.train.evaluate import relative_l2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    device = resolve_device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32, "cuBLAS TF32 is on")
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    check(torch.get_float32_matmul_precision() == "highest", "fp32 matmul precision not highest")
    emit(card, phase="device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32=False)

    # -- 2 build (every kernel, one nvcc each, all started together) -------
    t0 = time.perf_counter()
    build.prebuild(KERNELS)
    for name in KERNELS:
        build.load_library(name)
        ptxas = [ln.strip() for ln in build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        emit(card, phase="build", kernel=name, seconds=time.perf_counter() - t0,
             nvcc_seconds=build.BUILD_SECONDS.get(name),
             library=os.path.relpath(str(build.library_path(name)), ROOT), ptxas=ptxas)

    # -- 3 kernel vs plain -----------------------------------------------
    # the 8x20 net is the served model (the trained JAX fixture); the 8x200
    # net has random weights from a seed
    fx = np.load(FIXTURE, allow_pickle=False)
    loaded = load_params_npz(FIXTURE)
    check(loaded["spec"].layers == NARROW, f"fixture widths {loaded['spec'].layers}")
    wide = MLPSpec(layers=WIDE, lb=LB, ub=UB)
    euler = MLPSpec(layers=EULER, lb=LB, ub=UB)
    nets = {
        NARROW: (loaded["spec"], params_from_jax(loaded["params"], device)),
        WIDE: (wide, init_mlp(wide, torch.Generator().manual_seed(200), device)),
        EULER: (euler, init_mlp(euler, torch.Generator().manual_seed(203), device)),
    }
    main_err = None
    for layers, n in KERNEL_SHAPES:
        spec, params = nets[layers]
        x = points(n, seed=n, device=device)
        with torch.inference_mode():
            got = k_taylor2.taylor2(spec, params, x)
            want = mlp_taylor_2_reference(spec, params, x)
            if layers == WIDE:
                spec64 = dataclasses.replace(spec, dtype=torch.float64)
                params64 = [{k: v.double() for k, v in p.items()} for p in params]
                exact = mlp_taylor_2_reference(spec64, params64, x.double())
            torch.cuda.synchronize()
        host = lambda ts: [t.cpu().numpy() for t in ts]  # noqa: E731
        if layers == WIDE:
            rows = {s: compare_f64(s, g, w, e)
                    for s, g, w, e in zip(STREAMS, host(got), host(want), host(exact))}
        else:
            rows = {s: compare(s, g, w)
                    for s, g, w in zip(STREAMS, host(got), host(want))}
        if (layers, n) == MAIN_SHAPE:
            main_err = max(r["max_abs_err"] for r in rows.values())
        emit(card, phase="kernel", net=f"{len(layers) - 2}x{max(layers)}", n=n,
             criterion="f64_oracle" if layers == WIDE else "tol_vs_plain",
             launch=dataclasses.asdict(k_taylor2.launch_config(layers)), streams=rows)

    timed(card, "ragged", phase_ragged, card)

    # -- 4 the slice against JAX ----------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        art = export_predict(loaded["spec"], loaded["params"], os.path.join(tmp, "artifact"),
                             lambda1=loaded["lambda1"], lambda2=loaded["lambda2"],
                             experiment=loaded["experiment"])
        served = ServedModel(art, device="cuda")
        x_star = fx["X_star"]
        k_taylor2.LAUNCHES = 0
        out = served.predict(x_star, pad_to_bucket=True)
        launches = k_taylor2.LAUNCHES
        check(launches > 0, "the served predict never launched the taylor2 kernel")
        rows = {k: compare(k, out[k], fx[f"{k}_jax"]) for k in ("u", "f")}
        rel = relative_l2(out["u"], fx["u_star"])
        rel_jax = float(fx["rel_l2_jax"])
        check(abs(rel - rel_jax) <= 1e-5, f"rel-L2 {rel} vs JAX {rel_jax}")
        emit(card, phase="slice", experiment=loaded["experiment"], n=int(x_star.shape[0]),
             bucket=served.bucket_size(x_star.shape[0]), fields=rows,
             rel_l2_u=rel, rel_l2_u_jax=rel_jax, taylor2_launches=launches)

        # -- 5 HTTP -----------------------------------------------------
        server = make_http_server(art, port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://127.0.0.1:%d" % server.server_address[1]
            code, _, body = http(base + "/meta")
            check(code == 200 and json.loads(body) == served.meta, "GET /meta")
            x8 = x_star[:8]
            code, _, body = http(base + "/predict", json.dumps({"x": x8.tolist()}).encode())
            check(code == 200, f"JSON POST answered {code}: {body[:200]!r}")
            want8 = served.predict(x8, pad_to_bucket=True)
            got8 = {k: np.asarray(v, np.float32) for k, v in json.loads(body).items()}
            check(all(np.array_equal(got8[k], want8[k]) for k in want8), "JSON predict differs")
            x64k = points(65_536, seed=7, device="cpu").numpy()
            buf = io.BytesIO()
            np.save(buf, x64k)
            code, ctype, body = http(base + "/predict", buf.getvalue(), "application/x-npy")
            check(code == 200 and ctype == "application/x-npz", f"npy POST answered {code}")
            want64k = served.predict(x64k, pad_to_bucket=True)
            with np.load(io.BytesIO(body)) as z:
                check(all(np.array_equal(z[k], want64k[k]) for k in want64k),
                      "npy predict differs")
            code, _, body = http(base + "/predict", b"{not json")
            check(code == 400 and "error" in json.loads(body), f"malformed body answered {code}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "HTTP server thread did not stop")
        emit(card, phase="http", meta=True, json_points=8, npy_points=65_536,
             malformed_status=400)

        # -- 6 times ----------------------------------------------------
        main_ms = main_plain_ms = None
        for layers, n in KERNEL_SHAPES:
            spec, params = nets[layers]
            x = points(n, seed=n, device=device)
            with torch.inference_mode():
                ms = event_ms(lambda: k_taylor2.taylor2(spec, params, x))
                plain = event_ms(lambda: mlp_taylor_2_reference(spec, params, x))
            if (layers, n) == MAIN_SHAPE:
                main_ms, main_plain_ms = ms, plain
            emit(card, phase="times", what="taylor2", net=f"{len(layers) - 2}x{max(layers)}",
                 n=n, kernel_ms=ms, plain_ms=plain, reps=REPS, clock="cuda_events",
                 bound_ms=taylor2_bound(layers, n)[0])
        for n in (25_600, 1_048_576):
            xs = np.resize(x_star, (n, 2)) if n > x_star.shape[0] else x_star[:n]
            ms = host_ms(lambda: served.predict(xs, pad_to_bucket=True))
            emit(card, phase="times", what="served_predict", net="8x20", n=n,
                 ms=ms, points_per_s=n / (ms / 1e3), reps=REPS, clock="host")

    # -- 7-9 and times: the training path (Adam on K3) ----------------------
    step = timed(card, "step-kernel", phase_step_kernel, card)
    timed(card, "train-slice", phase_train_slice, card)
    train = timed(card, "train", phase_train, card)
    train_wide = timed(card, "train-wide", phase_train_wide, card)
    epoch_ms = timed(card, "times", phase_step_times, card,
                     {"8x20": step["narrow"], "8x200": step["wide"]})

    # -- 10-15 and times: the L-BFGS phase and the generic step (K5, K2) -----
    k5 = timed(card, "k5", phase_mlp_kernels, card, nets)
    k2 = timed(card, "k2", phase_taylor2_backward, card, nets)
    timed(card, "cross-check", phase_cross_check, card)
    timed(card, "lbfgs-replay", phase_lbfgs_replay, card)
    hybrid = timed(card, "hybrid", phase_hybrid, card, train)
    bf = timed(card, "burgers_forward", phase_burgers_forward, card)
    t3 = timed(card, "times-slice3", phase_slice3_times, card, nets, bf)

    # -- 16-18 and times: the scale slice (microbatching, K6) ---------------
    k6 = timed(card, "k6", phase_k6, card, nets)
    timed(card, "scale-replay", phase_scale_replay, card)
    scale = timed(card, "burgers_scale", phase_burgers_scale, card)
    t6 = timed(card, "times-k6", phase_k6_times, card, nets)

    # -- 19-22 and times: the Euler slice (K7a, K5 at out_dim 3) ------------
    timed(card, "euler-serve", phase_euler_serve, card)
    k7a = timed(card, "k7a", phase_k7a, card)
    timed(card, "euler-step", phase_euler_step, card)
    euler = timed(card, "euler-train", phase_euler_train, card)
    t7 = timed(card, "times-euler", phase_euler_times, card, euler)

    # -- 23-26 and times: P2 and the weak-form slice (K7b) ------------------
    timed(card, "p2", phase_p2, card)
    k7b_err = timed(card, "k7b", phase_k7b, card)
    timed(card, "weak-step", phase_weak_step, card)
    weak = timed(card, "weak-train", phase_weak_train, card)
    t8 = timed(card, "times-weak", phase_weak_times, card, weak)

    # -- 27-29 and times: the shock-path slice (paths in K7a and K5) --------
    paths_err = timed(card, "k7a/k5-paths", phase_paths, card)
    timed(card, "weak-paths-step", phase_path_step, card)
    ewf = timed(card, "euler_weak_fast", phase_path_train, card)
    t9 = timed(card, "times-paths", phase_path_times, card, ewf)

    with tempfile.TemporaryDirectory() as ens_tmp:
        # -- 30-32: ensembles (K8, the member-batched narrow K3) ------------
        k8 = timed(card, "k8", phase_k8, card)
        ens_cli = timed(card, "ensemble-cli", phase_ensemble_cli, card, ens_tmp)
        t10 = timed(card, "times-ensemble", phase_ensemble_times, card)

        # -- 33-35 and times: serving an ensemble (K8s) ---------------------
        k8s = timed(card, "k8s", phase_k8s, card)
        timed(card, "ens-fixture", phase_ens_fixture, card)
        serve = timed(card, "ensemble-serve", phase_ensemble_serve, card, ens_tmp, ens_tmp)
        t11 = timed(card, "times-ens-serve", phase_ens_serve_times, card, serve)

        # -- 36 and times: K9, the fused step's chunk as captured CUDA graphs --
        k9 = timed(card, "k9", phase_k9, card)
        t12 = timed(card, "times-k9", phase_k9_times, card)

        # -- 37: K10, the L-BFGS solve on the device (phase 14 ran it in training)
        k10 = timed(card, "k10", phase_k10, card)

        # -- 38-39: K7b's entropy mode; the Euler L-BFGS branch from phase 35's
        # euler_weak_fast members (this slice's main path)
        ent = timed(card, "k7b-entropy", phase_k7b_entropy, card)
        ewf_members = [os.path.join(ens_tmp, "ewf", f"{PATH_PRESET}_final_m{i}.ckpt")
                       for i in range(ENS_EULER["members"])]
        tail = timed(card, "euler-tail", phase_euler_tail, card, ewf_members,
                     ENS_EULER["epochs"])

    # -- 40: K10's outer epochs as chunks (phase 14 ran them in training)
    chunk = timed(card, "lbfgs-chunk", phase_lbfgs_chunk, card, train)

    # -- 41: K9 for the generic step and K11 (phases 15, 22, 26, 29 trained on them)
    generic = timed(card, "generic-chunk", phase_generic_chunk, card)

    # -- 42-45: the rest of slice 2b-iii (Fourier features in K1/K2, K7a and
    # K5; K1/K2's shock paths; the weak-form ADMM; RAD; SWA)
    t_2b = time.perf_counter()
    feats = timed(card, "fourier-kernels", phase_features, card)
    fourier = timed(card, "fourier-train", phase_fourier_train, card)
    timed(card, "flux-admm", phase_flux_admm, card)
    timed(card, "rad-swa", phase_rad_swa, card)
    emit(card, phase="wall", of="phases 42-45", seconds=time.perf_counter() - t_2b)
    fruns = fourier["runs"]

    # -- 46: the float64 modes of K1, K2, K5 and K10, and polish on the card
    pol = timed(card, "polish", phase_polish, card)

    dp = timed(card, "dp", phase_dp, card)

    # -- 48: the data generators, on the FV time stepper K12
    gen = timed(card, "generators", phase_generators, card)

    # -- 49: burgers_inverse's L-BFGS outer epoch, captured into K10's loop
    inverse = timed(card, "inverse-lbfgs", phase_inverse_lbfgs, card)

    def feat(counter, family, layers, n, f, k, which, run):
        return feature_entry(fruns, counter, feats, (family, layers, n, f, k), which, run)

    check(main_err is not None and math.isfinite(main_ms), "main-shape numbers missing")
    k5_main, k5_wide, k2_main = (NARROW, 100), (WIDE, 100), (NARROW, 1_000)
    k5_wide_launches = scale["f32"]["launches"]
    k6_launches = scale[K6_MAIN[0]]["launches"]
    k6_times = t6[K6_MAIN]
    print(json.dumps({"kernels": [{
        "name": "taylor2",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/taylor2.cu",
        "replaces": "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:420",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": main_ms,
        "plain_ms": main_plain_ms,
        **bound_fields(taylor2_bound(*MAIN_SHAPE)),
        # the tiled design with Fourier features (F 16: input width 34) and
        # with two shock paths (phase 42); launches: phase 43's
        # burgers_forward runs with each
        "fourier_8x20_n25600": feat("taylor2", "taylor2", NARROW, 25_600, 16, 0, "forward",
                                    "burgers_fourier"),
        "fourier_8x200_n8192": feat("taylor2", "taylor2", WIDE, 8_192, 16, 0, "forward",
                                    "burgers_fourier"),
        "paths_8x20_n1000": feat("taylor2", "taylor2", NARROW, 1_000, 0, 2, "forward",
                                 "burgers_paths"),
    }, {
        "name": "fused_step",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/fused_step.cu",
        "replaces": "3266821^:pinns_tpu/ops/pallas/fused_step.py:304",
        "launches": train["launches"],
        "max_abs_err": step["grad_err"],
        "ms": epoch_ms["8x20"][0],
        "plain_ms": epoch_ms["8x20"][1],
        **bound_fields(step_bound(NARROW, 1_000, 100)),
        # the narrow design's grad and tail kernels, redesigned from 64-point
        # tiles (18 grad blocks) to 8-point grad and 7-point tail tiles that
        # fill the card: their device time in a graphed 8x20 epoch (phase
        # 36's times)
        "narrow_design": {
            "grad_tile": step["plan"].tile, "tail_tile": step["plan"].tail_tile,
            "grad_blocks": step["plan"].blocks, "tail_blocks": step["plan"].tail_blocks,
            "grad_kernel_us": t12["8x20"][4]["grad_kernel"],
            "tail_kernel_us": t12["8x20"][4]["tail_kernel"],
            **narrow_bound_fields(1),
        },
        # the wide design at abgrall_l1's net; its launches: phase 9b
        "wide_8x200": {
            "launches": train_wide["launches"],
            "max_abs_err": step["wide_grad_err"],
            "ms": epoch_ms["8x200"][0],
            "plain_ms": epoch_ms["8x200"][1],
            **bound_fields(step_bound(WIDE, 1_000, 100)),
        },
    }, {
        "name": "mlp_forward",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/mlp_forward.cu",
        "replaces": "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:103",
        # since K10's chunks the hybrid's L-BFGS phase runs no K5: its
        # launches are burgers_forward's generic Adam epochs (phase 15)
        "launches": bf["launches"]["mlp_forward"],
        "max_abs_err": k5[k5_main][0],
        "ms": t3[("k5",) + k5_main][0],
        "plain_ms": t3[("k5",) + k5_main][1],
        **bound_fields(mlp_bound(*k5_main)),
        # the wide design at burgers_scale's data term; its launches: phase 18, f32
        "wide_8x200_n100": {
            "launches": k5_wide_launches["mlp_forward"],
            "max_abs_err": k5[k5_wide][0],
            "ms": t3[("k5",) + k5_wide][0],
            "plain_ms": t3[("k5",) + k5_wide][1],
            **bound_fields(mlp_bound(*k5_wide)),
        },
        # the wide design with two shock paths on euler_weak_fast's data term
        "paths_euler_n200": path_entry(ewf, "mlp_forward", paths_err, t9, "k5",
                                       PATH_K5_MAIN, 0),
        # with Fourier features on the Euler trunk (phase 42); launches:
        # phase 43's euler_admm run with them
        "fourier_euler_n1000": feat("mlp_forward", "mlp", EULER, 1_000, 16, 0, "forward",
                                    "euler_fourier"),
    }, {
        "name": "mlp_backward",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/mlp_forward.cu",
        "replaces": "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:103",
        # since K10 the hybrid's L-BFGS phase runs no backward of K5: its
        # launches are burgers_forward's generic Adam epochs (phase 15)
        "launches": bf["launches"]["mlp_backward"],
        "max_abs_err": k5[k5_main][1],
        "ms": t3[("k5",) + k5_main][2],
        "plain_ms": t3[("k5",) + k5_main][3],
        **bound_fields(mlp_bound(*k5_main, backward=True)),
        "wide_8x200_n100": {
            "launches": k5_wide_launches["mlp_backward"],
            "max_abs_err": k5[k5_wide][1],
            "ms": t3[("k5",) + k5_wide][2],
            "plain_ms": t3[("k5",) + k5_wide][3],
            **bound_fields(mlp_bound(*k5_wide, backward=True)),
        },
        "paths_euler_n200": path_entry(ewf, "mlp_backward", paths_err, t9, "k5",
                                       PATH_K5_MAIN, 1),
        "fourier_euler_n1000": feat("mlp_backward", "mlp", EULER, 1_000, 16, 0, "backward",
                                    "euler_fourier"),
    }, {
        "name": "taylor2_backward",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/taylor2_backward.cu",
        "replaces": "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:391",
        "launches": bf["launches"]["taylor2_backward"],
        "max_abs_err": k2[k2_main],
        "ms": t3[("k2",) + k2_main][0],
        "plain_ms": t3[("k2",) + k2_main][1],
        **bound_fields(taylor2_backward_bound(*k2_main)),
        "fourier_8x20_n1000": feat("taylor2_backward", "taylor2", NARROW, 1_000, 16, 0,
                                   "backward", "burgers_fourier"),
        "paths_8x20_n1000": feat("taylor2_backward", "taylor2", NARROW, 1_000, 0, 2,
                                 "backward", "burgers_paths"),
    }, {
        "name": "taylor2_mixed",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/taylor2.cu",
        "replaces": "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:329",
        "launches": k6_launches["taylor2_mixed"],
        "max_abs_err": k6[K6_MAIN][0],
        "ms": k6_times[0],
        "plain_ms": k6_times[1],
        **bound_fields(k6_times[4]),
    }, {
        "name": "taylor2_mixed_backward",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/taylor2_backward.cu",
        "replaces": "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:391",
        "launches": k6_launches["taylor2_mixed_backward"],
        "max_abs_err": k6[K6_MAIN][1],
        "ms": k6_times[2],
        "plain_ms": k6_times[3],
        **bound_fields(k6_times[5]),
    }, {
        "name": "taylor1",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/taylor1.cu",
        "replaces": "pinns_tpu/ops/taylor.py:91",
        "launches": euler["launches"]["taylor1"],
        "max_abs_err": k7a[K7A_MAIN][0],
        "ms": t7[K7A_MAIN][0],
        "plain_ms": t7[K7A_MAIN][1],
        **bound_fields(taylor1_bound(*K7A_MAIN)),
        # with two shock paths at euler_weak_fast's edge points; its
        # launches: phase 29's first seed (edge points and centres)
        "paths_n16000": path_entry(ewf, "taylor1", paths_err, t9, "k7a", PATH_K7A_MAIN, 0),
        # with Fourier features (F 16: input width 34) on the trunk, and with
        # Fourier features and two paths (phase 42); launches: phase 43's
        # euler_admm and euler_weak_fast runs with them
        **{f"fourier_euler_n{n}": feat("taylor1", "taylor1", EULER, n, 16, 0, "forward",
                                       "euler_fourier") for n in (1_000, 16_000)},
        "fourier_paths_euler_n16000": feat("taylor1", "taylor1", EULER, 16_000, 16, 2,
                                           "forward", "weak_fourier_paths"),
    }, {
        "name": "taylor1_backward",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/taylor1.cu",
        "replaces": "pinns_tpu/ops/taylor.py:91",
        "launches": euler["launches"]["taylor1_backward"],
        "max_abs_err": k7a[K7A_MAIN][1],
        "ms": t7[K7A_MAIN][2],
        "plain_ms": t7[K7A_MAIN][3],
        **bound_fields(taylor1_backward_bound(*K7A_MAIN)),
        "paths_n16000": path_entry(ewf, "taylor1_backward", paths_err, t9, "k7a",
                                   PATH_K7A_MAIN, 1),
        **{f"fourier_euler_n{n}": feat("taylor1_backward", "taylor1", EULER, n, 16, 0,
                                       "backward", "euler_fourier") for n in (1_000, 16_000)},
        "fourier_paths_euler_n16000": feat("taylor1_backward", "taylor1", EULER, 16_000, 16, 2,
                                           "backward", "weak_fourier_paths"),
    }] + [{
        # K7a's narrow design (8x20): twosin_weak's edge points, phase 26's
        # first seed its launches
        "name": f"taylor1_narrow{suffix}",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/taylor1.cu",
        "replaces": "pinns_tpu/ops/taylor.py:91",
        "launches": weak["launches"][f"taylor1_narrow{suffix}"],
        "max_abs_err": k7a[K7A_NARROW_MAIN][i],
        "ms": t7[K7A_NARROW_MAIN][2 * i],
        "plain_ms": t7[K7A_NARROW_MAIN][2 * i + 1],
        **bound_fields(bound_fn(*K7A_NARROW_MAIN)),
    } for i, (suffix, bound_fn) in enumerate((("", taylor1_bound),
                                              ("_backward", taylor1_backward_bound)))] + [{
        "name": "fused_step_ensemble",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/fused_step.cu",
        "replaces": "pinns_tpu/parallel/ensemble.py:66",
        # K8 epochs of phase 31's main path: host calls and replayed epochs
        "launches": (ens_cli["launches"]["fused_step_ensemble"]
                     + ens_cli["launches"]["fused_chunk_epochs"]),
        "max_abs_err": k8["grad_err"],
        "ms": t10[K8_MAIN][0],
        "plain_ms": t10[K8_MAIN][2],
        **bound_fields(t10[K8_MAIN][3]),
        "members": K8_MAIN,
        "member_epochs_per_s": t10[K8_MAIN][1],
        # the other member counts of phase 32, and the solo K3 beside them
        **{f"e{n}": {"ms": t10[n][0], "member_epochs_per_s": t10[n][1],
                     **bound_fields(t10[n][3])} for n in K8_TIMES if n != K8_MAIN},
        "solo_k3": {"ms": t10["solo"][0], "epochs_per_s": t10["solo"][1]},
    }, {
        # K9: the chunk as captured CUDA graphs of the fused step's epochs;
        # launches = phase 9's replays, times = a 1,000-epoch chunk, its
        # plain version the per-epoch loop, the bound the epoch's x 1,000
        "name": "fused_chunk",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/fused_step.cu",
        "replaces": "pinns_tpu/train/trainer.py:835",
        "launches": train["replays"],
        "max_abs_err": k9["max_abs_err"],
        "ms": t12["8x20"][0],
        "plain_ms": t12["8x20"][1],
        **bound_fields(t12["8x20"][2]),
        "epochs": K9_CHUNK,
        "capture_s": t12["8x20"][3],
        **{cell: {"ms": t12[cell][0], "plain_ms": t12[cell][1], **bound_fields(t12[cell][2]),
                  "capture_s": t12[cell][3]} for cell in ("8x200", "k8_e8", "k8_e32")},
    }, {
        "name": "taylor2_members",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/taylor2.cu",
        "replaces": "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:420",
        "launches": serve["launches"]["taylor2_members"],
        "max_abs_err": k8s["members_err"],
        "ms": t11["members"][0],
        "plain_ms": t11["members"][1],
        **bound_fields(t11["members"][2]),
        "members": K8S_MAIN[1],
        "solo_k1_calls_ms": t11["members"][3],
    }, {
        "name": "member_stats",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/ensemble.cu",
        "replaces": "pinns_tpu/parallel/ensemble.py:340",
        "launches": serve["launches"]["member_stats"],
        "max_abs_err": k8s["reduce_err"],
        "ms": t11["reduce"][0],
        "plain_ms": t11["reduce"][1],
        "bound_ms": t11["reduce"][2][0],
        "bound_by": t11["reduce"][2][1],
        # torch.std_mean over the members: mean and std, not the dx mean
        "library_ms": t11["reduce"][3],
    }] + [{
        "name": f"weakform_{what}",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/weakform.cu",
        "replaces": "pinns_tpu/ops/weakform.py:87,182",
        "launches": weak["launches"][counter],
        "max_abs_err": 0.0 if what == "edge_points" else k7b_err[K7B_MAIN][err],
        "ms": t8[K7B_MAIN][key][0],
        "plain_ms": t8[K7B_MAIN][key][1],
        **bound_fields(t8[K7B_MAIN][key][2]),
        # the Euler system (euler_inverse: 3 fields, viscous, 1,000 cells)
        "euler_n1000": {
            "launches": weak["euler_launches"][counter],
            "max_abs_err": 0.0 if what == "edge_points" else k7b_err[K7B_EULER][err],
            "ms": t8[K7B_EULER][key][0],
            "plain_ms": t8[K7B_EULER][key][1],
            **bound_fields(t8[K7B_EULER][key][2]),
        },
        # the entropy mode (phase 38): launches in the entropy-weighted loss
        # of twosin_weak (Burgers) and of euler_weak_fast (Euler), times at
        # 1,000 cells
        **({} if what == "edge_points" else {f"entropy_{kind}_n1000": {
            "launches": ent["steps"][preset]["launches"][counter.replace("flux", "flux_entropy")],
            "max_abs_err": ent["kernels"][(kind, True, 1_000)][err],
            "ms": ent["times"][(kind, True, 1_000)][key][0],
            "plain_ms": ent["times"][(kind, True, 1_000)][key][1],
            **bound_fields(ent["times"][(kind, True, 1_000)][key][2]),
        } for kind, preset in zip(("burgers", "euler"), ENTROPY_PRESETS)}),
    } for what, counter, key, err in (
        ("edge_points", "weakform_edge_points", "edge", None),
        ("flux", "weakform_flux", "forward", 0),
        ("flux_backward", "weakform_flux_backward", "backward", 1))] + [{
        # K10: launches = phase 14's (the hybrid's 10 L-BFGS outer epochs, the
        # launches inside its graph replays); the control and direction
        # kernels bit-equal to their plain versions (phase 37); times on the
        # heaviest input phase 37's solve met, by the profiler
        "name": name,
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/" + (
            "fused_step.cu" if name == "fused_value_and_grad" else "lbfgs.cu"),
        "replaces": replaces,
        "launches": hybrid["launches"][name],
        "max_abs_err": k10["max_abs_err"] if name == "fused_value_and_grad" else 0.0,
        "ms": k10["kernels"][name][0],
        "plain_ms": k10["kernels"][name][1],
        **bound_fields(k10["bounds"][name]),
        **({"solve": {"preset": "abgrall_admm", "max_iters": LONG_SOLVE, **k10["times"]["k10"],
                      "host_loop": k10["times"]["host_loop"]}} if name == "lbfgs_control" else {}),
        # the Euler branch (phase 39): launches of the CLI tail, the kernels
        # at the trunk's 162,413 params and a full history of 50 pairs
        **({f"euler_tail_n{K10_EULER_N}": {
            "launches": tail["launches"][name],
            "max_abs_err": 0.0,
            "ms": tail["kernels"][name.split("_")[1]][0],
            "plain_ms": tail["kernels"][name.split("_")[1]][1],
            **bound_fields(tail["bounds"][name]),
            **({"outer_epoch": {"max_iters": TAIL_TIMED_ITERS, **tail["times"]}}
               if name == "lbfgs_control" else {}),
        }} if name in ("lbfgs_control", "lbfgs_direction") else {}),
        **({"euler_tail_launches": tail["launches"]["lbfgs_reset"]}
           if name == "lbfgs_reset" else {}),
        # burgers_inverse's outer epoch (phase 49): captured beside host-stepped
        **({"burgers_inverse_outer_epoch": {"max_iters": INVERSE_MAX_ITERS,
                                            **inverse["times"]}}
           if name == "lbfgs_control" else {}),
    } for name, replaces in (
        ("lbfgs_control", "pinns_tpu/opt/lbfgs.py:194"),
        ("lbfgs_direction", "pinns_tpu/opt/lbfgs.py:167"),
        ("lbfgs_reset", "pinns_tpu/opt/lbfgs.py:194"),
        ("fused_value_and_grad", "pinns_tpu/opt/lbfgs.py:206"))] + [{
        # K3's post-update mode, the tail of K10's outer epochs in chunks:
        # launches = phase 14's (one a replay of the post-update graph),
        # max_abs_err = z against its plain version (phase 40), times in
        # phase 40; the outer epoch on the runner beside the per-outer-epoch
        # step (host clock, phase 40's turns)
        "name": "fused_post_update",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/fused_step.cu",
        "replaces": "pinns_tpu/train/trainer.py:663",
        "launches": hybrid["launches"]["fused_post_update"],
        "max_abs_err": chunk["max_abs_err"],
        "ms": chunk["kernel"][0],
        "plain_ms": chunk["kernel"][1],
        **bound_fields(chunk["bound"]),
        "outer_epoch": chunk["times"],
    }, {
        # K11, the generic step's Philox draw: launches = phase 22's first
        # euler_admm run (its epochs' draws inside K9's generic replays, the
        # initial batch); times at the presets' 1,000 points, and at
        # burgers_scale's 1,048,576 (its per-epoch loop draws with K11 too)
        "name": "philox_draw",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/sampling.cu",
        "replaces": "pinns_tpu/train/trainer.py:360",
        "launches": euler["launches"]["philox_draw"],
        "max_abs_err": 0.0,
        "ms": generic["k11"][K11_NS[0]][0],
        "plain_ms": generic["k11"][K11_NS[0]][1],
        **bound_fields(generic["k11"][K11_NS[0]][2]),
        f"n{K11_NS[1]}": {"ms": generic["k11"][K11_NS[1]][0],
                          "plain_ms": generic["k11"][K11_NS[1]][1],
                          **bound_fields(generic["k11"][K11_NS[1]][2])},
        "row_offset_union_bit_equal": dp["draws"],
    }, {
        # K9 for the generic step: launches = phase 22's first run's graph
        # replays; max_abs_err over phase 41's chunks against the per-epoch
        # loop (bit for bit); ms an epoch in a 1,000-epoch euler_admm chunk,
        # its plain version the per-epoch loop, the bound the sum of the
        # epoch's kernel bounds; the other presets beside it
        "name": "generic_chunk",
        "route": "cuda",
        "source": "pinns_tpu_torch/ops/kernels/generic_chunk.py",
        "replaces": "pinns_tpu/train/trainer.py:835",
        "launches": euler["launches"]["generic_chunk_replays"],
        "max_abs_err": generic["max_abs_err"],
        "ms": generic["times"]["euler_admm"][0],
        "plain_ms": generic["times"]["euler_admm"][1],
        **bound_fields(generic["times"]["euler_admm"][2]),
        "unit": "ms an epoch",
        **{preset: {"ms": t[0], "plain_ms": t[1], **bound_fields(t[2]), "device_ms": t[3],
                    "idle_share": t[4], "launches_per_epoch": t[5]}
           for preset, t in generic["times"].items() if preset != "euler_admm"},
    }] + [{
        # the float64 modes (phase 46): launches = one polish of
        # POLISH_ITERS iterations from the committed JAX state of
        # burgers_forward; max_abs_err against the float64 plain version on
        # the same inputs (K10: bit for bit); times by CUDA events at the
        # polish's shapes; bounds at the float64 rate
        "name": name,
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/" + source,
        "replaces": replaces,
        "launches": pol["launches"][name],
        "max_abs_err": pol["kernels"][name]["max_abs_err"],
        "ms": pol["times"][name][0],
        "plain_ms": pol["times"][name][1],
        **bound_fields(pol["bounds"][name]),
        **({"polish": pol["polish"]} if name == "lbfgs_control_f64" else {}),
    } for name, source, replaces in (
        ("taylor2_f64", "taylor2.cu", "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:420"),
        ("taylor2_backward_f64", "taylor2_backward.cu",
         "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:391"),
        ("mlp_forward_f64", "mlp_forward.cu", "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:103"),
        ("mlp_backward_f64", "mlp_forward.cu", "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:103"),
        ("lbfgs_control_f64", "lbfgs.cu", "pinns_tpu/opt/lbfgs.py:194"),
        ("lbfgs_direction_f64", "lbfgs.cu", "pinns_tpu/opt/lbfgs.py:167"),
        ("lbfgs_reset_f64", "lbfgs.cu", "pinns_tpu/opt/lbfgs.py:194"))] + dp_entries(dp)
        + fv_entries(gen)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
