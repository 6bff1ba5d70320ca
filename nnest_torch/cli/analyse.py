"""Aggregate repeated nested runs: the port of ``nnest_tpu``'s
``examples/nested/analyse.py``.

Example::

    python -m nnest_torch.cli.analyse --root 'logs/*' --dim 2

Prints logZ mean and spread, the logZ error estimate, the likelihood calls,
the posterior ESS and the run diagnostics (insertion p-values, mixing and
structure ratios, quality flags, the sampling and implementation errors)
of every ``runN`` directory under each root, from the artifact contract
(``info/params.txt``, ``results/final.csv``, ``results/diagnostics.json``,
``results/insertion_ranks.npy``, ``results/threads.npz``,
``chains/chain.txt``). ``--merge`` combines the runs into one
(``utils/evaluation.merge_runs``), ``--merge_chain`` also writes the merged
posterior chain, ``-plot`` draws a triangle plot a run (getdist when
installed, else a matplotlib corner plot). The output is the JAX script's,
line for line.
"""

import argparse
import csv
import glob
import json
import os

import numpy as np


def read_final_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    header, vals = rows[0], rows[1]
    return dict(zip(header, [float(v) for v in vals]))


def read_chain(path):
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    weights, minus_logl, params = data[:, 0], data[:, 1], data[:, 2:]
    return weights, -minus_logl, params


def posterior_ess(weights):
    return float(np.sum(weights) ** 2 / np.sum(weights ** 2))


def main(args):
    # Normalize optional flags once: programmatic callers (tests,
    # notebooks) may pass a partial Namespace. Doing it here — rather
    # than getattr-gating each use site — keeps a future CLI
    # parser-wiring regression loud (the argparse path always sets
    # these) while tolerating partial Namespaces uniformly.
    for k, v in {'merge': False, 'merge_chain': False,
                 'plot': False}.items():
        if not hasattr(args, k):
            setattr(args, k, v)
    log_roots = glob.glob(args.root)
    x_dims = [args.dim] if args.dim != 0 else list(range(2, 51))

    for log_root in log_roots:
        print('\n------------------------\n%s\n------------------------'
              % log_root)
        by_dim = {d: [] for d in x_dims}
        for log_dir in glob.glob(os.path.join(log_root, 'run*')):
            ppath = os.path.join(log_dir, 'info', 'params.txt')
            if not os.path.exists(ppath):
                continue
            with open(ppath) as f:
                params = json.load(f)
            d = int(params['x_dim'])
            if d in by_dim:
                by_dim[d].append((log_dir, params))

        for d, runs in by_dim.items():
            if not runs:
                continue
            print('\n--------\nDim: %s (%d runs)\n--------' % (d, len(runs)))
            logzs, dlogzs, nlikes, ess, ins_ps = [], [], [], [], []
            boots, thread_files, chain_files = [], [], []
            mix_rs, cond_rs = [], []
            flagged_runs = []   # (run dir, quality_flags) per flagged run
            for log_dir, params in runs:
                fpath = os.path.join(log_dir, 'results', 'final.csv')
                cpath = os.path.join(log_dir, 'chains', 'chain.txt')
                rpath = os.path.join(log_dir, 'results',
                                     'insertion_ranks.npy')
                dpath = os.path.join(log_dir, 'results',
                                     'diagnostics.json')
                if params.get('sampler') == 'nested' and \
                        os.path.exists(fpath):
                    res = read_final_csv(fpath)
                    ins = ''
                    if os.path.exists(dpath):
                        with open(dpath) as f:
                            diag = json.load(f)
                        if diag.get('logzerr_bootstrap') is not None:
                            boots.append(float(diag['logzerr_bootstrap']))
                        # prefer the calibrated relative ratio (round 4);
                        # old diagnostics.json files only carry the
                        # coordinate-basis mixing_min_ratio
                        mkey = ('mixing_rel_ratio'
                                if diag.get('mixing_rel_ratio') is not None
                                else 'mixing_min_ratio')
                        if diag.get(mkey) is not None:
                            mix_rs.append(float(diag[mkey]))
                            ins += ' mixing_R=%.2f' % diag[mkey]
                        if diag.get('latent_cond_rel') is not None:
                            cond_rs.append(float(diag['latent_cond_rel']))
                        if diag.get('quality_flags'):
                            flagged_runs.append(
                                (os.path.basename(log_dir),
                                 diag['quality_flags']))
                            ins += ' FLAGS=%s' % ','.join(
                                diag['quality_flags'])
                    if os.path.exists(rpath):
                        from nnest_torch.utils.evaluation import insertion_ks
                        ranks = np.load(rpath)
                        _, p = insertion_ks(
                            ranks, int(params.get('num_live_points',
                                                  max(ranks.max() + 1, 1))))
                        ins_ps.append(p)
                        ins = ' insertion_p=%.3g' % p + ins
                    print('  %s: logz=%.3f±%.3f ncall=%d%s' % (
                        log_dir, res['logz'], res['logzerr'],
                        int(res['ncall']), ins))
                    logzs.append(res['logz'])
                    dlogzs.append(res['logzerr'])
                    nlikes.append(res['ncall'])
                    tpath = os.path.join(log_dir, 'results', 'threads.npz')
                    if os.path.exists(tpath):
                        thread_files.append(tpath)
                        chain_files.append(
                            cpath if os.path.exists(cpath) else None)
                    if os.path.exists(cpath):
                        w, logl, samp = read_chain(cpath)
                        ess.append(posterior_ess(w))
                        if args.plot:
                            _triangle(samp, w, log_dir)
            if len(logzs) > 1:
                print('Num runs: %d' % len(logzs))
                print('Log Z: %4.2f +/- %4.2f' % (np.mean(logzs),
                                                  np.std(logzs)))
                print('Log Z error estimate: %4.2f +/- %4.2f' % (
                    np.mean(dlogzs), np.std(dlogzs)))
                print('N_like: %.0f +/- %.0f' % (np.mean(nlikes),
                                                 np.std(nlikes)))
                if ess:
                    print('Posterior ESS: %.0f +/- %.0f' % (
                        np.mean(ess), np.std(ess)))
                if ins_ps:
                    k = len(ins_ps)
                    try:
                        # Fisher's method: -2 sum(ln p) ~ chi2(2k) under
                        # the (uniform-p) null, independent runs.
                        from scipy.stats import chi2
                        stat = -2.0 * np.sum(
                            np.log(np.maximum(ins_ps, 1e-300)))
                        comb = 'combined (Fisher) %.3g' % chi2.sf(stat,
                                                                  2 * k)
                    except ImportError:
                        comb = 'Bonferroni min %.3g' % min(
                            np.min(ins_ps) * k, 1.0)
                    print('Insertion p: %s (min %.3g over %d runs)' % (
                        comb, np.min(ins_ps), k))
                if mix_rs:
                    r = float(np.median(mix_rs))
                    print('Kernel mixing ratio: %.2f (median)%s' % (
                        r, ' — WARNING: under-mixed; the per-run '
                           'sqrt(h/N) bar under-covers by ~1/R^2 '
                           '= %.1fx (see logzerr_adjusted)' % min(
                               100.0, 1.0 / max(r, 1e-4) ** 2)
                        if r < 0.7 else ''))
                if cond_rs:
                    c = float(np.median(cond_rs))
                    print('Latent structure ratio: %.2f (median)%s' % (
                        c, ' — WARNING: structural anisotropy (curved '
                           'degeneracy the flow cannot whiten); the '
                           'sqrt(h/N) bar under-covers by ~%.1fx at ANY '
                           'step count (see logzerr_adjusted)' % min(
                               100.0, c)
                        if c > 2.0 else ''))
                if flagged_runs:
                    print('Quality flags: %d/%d runs flagged — %s' % (
                        len(flagged_runs), len(logzs),
                        '; '.join('%s: %s' % (name, ','.join(flags))
                                  for name, flags in flagged_runs)))
                if len(boots) > 1 and len(boots) == len(logzs):
                    # nestcheck-style implementation-error decomposition
                    # (arXiv:1804.06406 sec 5): the run-to-run logZ
                    # variance in excess of the (bootstrap-estimated)
                    # sampling variance is implementation error —
                    # under-mixed proposals, bounding biases, etc.
                    var_runs = float(np.var(logzs))
                    var_samp = float(np.mean(np.square(boots)))
                    imp = np.sqrt(max(var_runs - var_samp, 0.0))
                    print('Sampling error (bootstrap): %.3f; '
                          'implementation error: %.3f%s' % (
                              np.sqrt(var_samp), imp,
                              ' — WARNING: implementation error '
                              'comparable to the sampling error; '
                              'results may be biased (try more '
                              'mcmc_steps)' if imp > np.sqrt(var_samp)
                              else ''))
            if args.merge and len(thread_files) > 1:
                # Combined-run evidence (arXiv:1704.03459 / nestcheck):
                # the K runs' live counts add over every likelihood
                # interval, so the merged estimate behaves like one
                # ~K*N-live-point run — a 1/sqrt(K) tighter error from
                # runs you already paid for (the mean±std above treats
                # them as separate measurements instead).
                from nnest_torch.utils.evaluation import (load_threads_npz,
                                                          merge_runs)
                parts = [load_threads_npz(t) for t in thread_files]
                merged = merge_runs(parts)
                print('Merged logZ (combined run): %.4f +/- %.4f '
                      '(%d runs, peak live points %d, total N_like %.0f)'
                      % (merged['logz'], merged['logzerr'],
                         len(parts), int(np.max(merged['n_live'])),
                         float(np.sum(nlikes))))
                if args.merge_chain and all(
                        c is not None for c in chain_files):
                    rows, wts = [], np.exp(
                        merged['logwt'] - merged['logz'])
                    off = 0
                    ok = True
                    for cpath, part in zip(chain_files, parts):
                        w, logl, samp = read_chain(cpath)
                        n = part['logl'].size
                        if samp.shape[0] != n:
                            print('  (skipping merged chain: %s has %d '
                                  'rows, threads.npz has %d)'
                                  % (cpath, samp.shape[0], n))
                            ok = False
                            break
                        rows.append(np.hstack([
                            wts[off:off + n, None], -logl[:, None], samp]))
                        off += n
                    if ok:
                        out = os.path.join(log_root, 'merged_chain.txt')
                        np.savetxt(out, np.vstack(rows), fmt='%.5E')
                        print('Merged posterior chain (ESS %.0f): %s'
                              % (posterior_ess(np.vstack(rows)[:, 0]),
                                 out))


def _triangle(samples, weights, log_dir):
    try:
        import getdist
        import getdist.plots
        mc = getdist.MCSamples(samples=samples, weights=weights,
                               names=['p%d' % i
                                      for i in range(samples.shape[1])])
        g = getdist.plots.getSubplotPlotter()
        g.triangle_plot(mc, filled=True)
        g.export(os.path.join(log_dir, 'plots', 'triangle.png'))
    except ImportError:
        # self-contained fallback: weighted 2-D hist corner plot
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        d = samples.shape[1]
        fig, ax = plt.subplots(d, d, figsize=(2 * d, 2 * d))
        ax = np.atleast_2d(ax)
        for i in range(d):
            for j in range(d):
                if j > i:
                    ax[i, j].axis('off')
                elif i == j:
                    ax[i, j].hist(samples[:, i], bins=40, weights=weights)
                else:
                    ax[i, j].hist2d(samples[:, j], samples[:, i], bins=40,
                                    weights=weights)
        plt.tight_layout()
        plt.savefig(os.path.join(log_dir, 'plots', 'triangle.png'))
        plt.close(fig)


def build_parser():
    parser = argparse.ArgumentParser(
        description='Aggregate nested-sampling run directories.')
    parser.add_argument('--root', type=str, default='logs/*')
    parser.add_argument('--dim', type=int, default=0)
    parser.add_argument('--feedback', type=int, default=0)
    parser.add_argument('-plot', action='store_true')
    parser.add_argument('--merge', action='store_true',
                        help='also combine the runs into one merged run '
                             '(combined-run evidence, arXiv:1704.03459)')
    parser.add_argument('--merge_chain', action='store_true',
                        help='with --merge: write merged_chain.txt with '
                             'combined-run posterior weights')
    return parser


if __name__ == '__main__':
    main(build_parser().parse_args())
