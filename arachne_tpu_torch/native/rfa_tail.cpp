// Copy of arachne_tpu/native/rfa_tail.cpp, the JAX package's host code,
// grown into RFA's whole host stage for a superbatch of barcodes.
// For every hit: GetAlignments' walk of its CIGAR against its reference
// window (aligner.go:1484-1631: mismatch loci, indel and soft-clip
// counters), its log probabilities and the best-17 filter.  For every
// barcode: tagBestAlignments -> inferMolecules ->
// markBestAlignmentForReadInMolecule -> scrapMolecules -> greedy optimize ->
// estimateMapQualities on the kept hits, on flat arrays.
//
// Statement-faithful port of rfa/candidates.py, rfa/molecules.py,
// rfa/optimizer.py and rfa/mapq.py (themselves cited ports of
// aligner.go:1397-1481, :1300-1393, :991-1016, :1065-1298, :697-922).  Bit
// parity requirements honored:
//   * OrderedMap iteration order incl. swap-remove deletion
//     (ordered_map.go:39-51) — deletion order changes later fast_score
//     sweeps and therefore outputs;
//   * float accumulation order identical to the Python statement order
//     (alignment_change sums, dna_length sums, top-15 probability sum,
//     the log probabilities without fused multiply-adds);
//   * the md5-seeded jitter stream (JitterRand): seeds computed by the
//     caller (hashlib md5), doubles generated here with the same
//     splitmix64 -> (z >> 11) * 2^-53 mapping (utils/rng.py).
//
// The Python forms remain the reference implementation; parity is asserted
// field for field in tests/test_torch_rfa_native.py and end to end by the
// byte-identity e2e tests.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using std::vector;

constexpr double NEG_INF = -std::numeric_limits<double>::infinity();
constexpr double POS_INF = std::numeric_limits<double>::infinity();

struct In {
    int32_t R, A;
    const int64_t* pos;
    const int64_t* aend;
    const double* logp;       // log_alignment_probability
    const double* score;      // Alignment.score (int-valued)
    const int32_t* mismatches;
    const int32_t* indels;
    const int32_t* soft_clipped;
    const int32_t* soft_len;
    const int32_t* seq_len;
    const uint8_t* rev;
    const int32_t* contig;
    const int32_t* aln_id;
    const int32_t* read_of;   // (A) read index of each slot
    const int64_t* locs;      // mismatch_locs CSR values
    const int64_t* locs_off;  // (A+1)
    const int64_t* aln_off;   // (R+1)
    const int32_t* mate_of;   // (R)
    const uint64_t* jitter_seed;  // (R)
    double improper;
    double ref_len;
    int32_t run_rfa;
    int32_t temp_steps;
    int32_t anneal_factor;
    const int64_t* cen_start;  // per contig id, -1 = none
    const int64_t* cen_end;
};

struct Out {
    uint8_t* active;
    uint8_t* proper;
    uint8_t* bwa_pick;
    int32_t* mapq;
    int32_t* mol_id;
    uint8_t* active_mol;
    double* mol_conf;
    double* mol_diff;
    double* sum_move;
    int32_t* mate_slot;
    int32_t* sb_slot;
    double* sb_score;
    uint8_t* sb_proper;
    int32_t* sb_mol_reads;
    double* sb_mol_conf;
    int32_t* copies;
    int32_t* copies_in;
    int32_t* copies_out;
    int32_t* uniq_mols;
    double* md_score;
    int32_t* reads_in_mol;
    int32_t* n_molecules;
};

// Insertion-ordered int map with swap-remove delete (ordered_map.go:39-51).
struct OM {
    std::unordered_map<int32_t, int32_t> index;
    vector<int32_t> keys;
    vector<int32_t> vals;

    int32_t get(int32_t key) const {
        auto it = index.find(key);
        return it == index.end() ? -1 : vals[it->second];
    }
    void set(int32_t key, int32_t val) {
        auto it = index.find(key);
        if (it != index.end()) {
            vals[it->second] = val;
        } else {
            index.emplace(key, (int32_t)vals.size());
            keys.push_back(key);
            vals.push_back(val);
        }
    }
    void del(int32_t key) {
        auto it = index.find(key);
        if (it == index.end()) return;
        int32_t i = it->second;
        if (vals.size() > 1) {
            vals[i] = vals.back();
            index[keys.back()] = i;
            keys[i] = keys.back();
        }
        vals.pop_back();
        keys.pop_back();
        index.erase(it);
    }
    size_t size() const { return keys.size(); }
};

struct Molecule {
    int32_t id = 0;
    int32_t contig = 0;
    int64_t start = 0, stop = 0;
    OM aln_by_read;            // read -> index into read_maps
    vector<OM> read_maps;      // per-read (aln_id -> slot) maps
    OM best_for_read;          // read -> slot
    OM active;                 // read -> slot
    double confidence = 1.0;
    double differences = 0.0;
    int32_t soft_clipped = 0;
    bool active_molecule = false;
    std::unordered_map<int64_t, int32_t> mismatch_locs;

    OM* read_map(int32_t read) {
        int32_t i = aln_by_read.get(read);
        return i < 0 ? nullptr : &read_maps[i];
    }
    void add_aln(int32_t read, int32_t aid, int32_t slot) {
        int32_t i = aln_by_read.get(read);
        if (i < 0) {
            i = (int32_t)read_maps.size();
            read_maps.emplace_back();
            aln_by_read.set(read, i);
        }
        read_maps[i].set(aid, slot);
    }
};

static inline bool is_pair(const In& in, int32_t a, int32_t b) {
    if (in.rev[a] == in.rev[b] || in.contig[a] != in.contig[b]) return false;
    int32_t fwd = in.rev[a] ? b : a;
    int32_t rv = in.rev[a] ? a : b;
    int64_t dist = in.pos[rv] - in.pos[fwd];
    return dist >= -35 && dist < 750;
}

// scoreAlignment (aligner.go:556-581); slot -1 = nil.
static double score_alignment(const In& in, const Out& out, int32_t a,
                              int32_t m, double mol_pen, double improper) {
    double score = 0.0;
    if (a >= 0) {
        score += in.mismatches[a] * -2.0 + in.indels[a] * -3.0;
        if (in.soft_clipped[a] > 0) {
            score -= 5.0 * in.soft_clipped[a];
            score -= in.soft_len[a] * 0.5;
        }
    }
    if (m >= 0) {
        score += in.mismatches[m] * -2.0 + in.indels[m] * -3.0;
        if (in.soft_clipped[m] > 0) {
            score -= 5.0 * in.soft_clipped[m];
            score -= in.soft_len[m] * 0.5;
        }
    }
    if (m < 0 || a < 0 || !is_pair(in, a, m)) score += improper;
    if (a >= 0 && !out.active_mol[a]) score += mol_pen;
    return score;
}

static double pseudo_count_score(const In& in, int32_t a, double mol_pen) {
    double score = 0.0;
    score -= 10.0;
    score -= (in.seq_len[a] - 25.0) * 0.5;
    score += mol_pen;
    return score;
}

struct Jitter {
    uint64_t state;
    explicit Jitter(uint64_t seed) : state(seed) {}
    double next() {
        state += 0x9E3779B97F4A7C15ull;
        uint64_t z = state;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        z = z ^ (z >> 31);
        return (double)(z >> 11) * (1.0 / 9007199254740992.0);
    }
};

struct State {
    const In& in;
    Out& out;
    vector<Molecule> mols;
    State(const In& i, Out& o) : in(i), out(o) {}
    int64_t rbeg(int32_t r) const { return in.aln_off[r]; }
    int64_t rend(int32_t r) const { return in.aln_off[r + 1]; }
};

// ------------------------------------------------- tagBestAlignments

static void tag_best(State& st, vector<vector<int32_t>>& positions) {
    const In& in = st.in;
    Out& out = st.out;
    std::unordered_map<int32_t, int32_t> contig_bucket;
    vector<char> touched((size_t)in.R, 0);
    for (int32_t r = 0; r < in.R; ++r) {
        double best_score = NEG_INF;
        int32_t best_aln = -1, best_mate = -1;
        Jitter random(in.jitter_seed[r]);
        int32_t m = in.mate_of[r];
        for (int64_t a = st.rbeg(r); a < st.rend(r); ++a) {
            bool any_mate = st.rend(m) > st.rbeg(m);
            for (int64_t ma = st.rbeg(m); ma < st.rend(m); ++ma) {
                double total =
                    score_alignment(in, out, (int32_t)a, (int32_t)ma, 0.0,
                                    in.improper) +
                    random.next() / 2.0;
                if (total > best_score) {
                    best_score = total;
                    best_aln = (int32_t)a;
                    best_mate = (int32_t)ma;
                }
            }
            if (!any_mate) {
                double s = in.score[a] + random.next() / 2.0;
                if (s > best_score) {
                    best_score = s;
                    best_aln = (int32_t)a;
                    best_mate = -1;
                }
            }
            auto it = contig_bucket.find(in.contig[a]);
            if (it != contig_bucket.end()) {
                positions[it->second].push_back((int32_t)a);
            } else {
                contig_bucket.emplace(in.contig[a], (int32_t)positions.size());
                positions.emplace_back();
                positions.back().push_back((int32_t)a);
            }
        }
        if (!touched[r] && best_aln >= 0) {
            out.active[best_aln] = 1;
            out.bwa_pick[best_aln] = 1;
            if (best_mate >= 0) {
                if (is_pair(in, best_aln, best_mate)) {
                    out.proper[best_aln] = 1;
                    out.proper[best_mate] = 1;
                }
                out.active[best_mate] = 1;
                out.bwa_pick[best_mate] = 1;
                touched[m] = 1;
            }
        }
    }
    for (auto& plist : positions)
        std::stable_sort(plist.begin(), plist.end(),
                         [&](int32_t x, int32_t y) { return in.pos[x] < in.pos[y]; });
}

// --------------------------------------------------- inferMolecules

static void infer_molecules(State& st, const vector<vector<int32_t>>& positions) {
    const In& in = st.in;
    int32_t molecule_num = 0;
    int32_t cur = -1;
    for (const auto& plist : positions) {
        for (size_t i = 0; i < plist.size(); ++i) {
            int32_t a = plist[i];
            if (i == 0 || in.pos[a] - in.pos[plist[i - 1]] > 50000) {
                if (i > 0 && cur >= 0) st.mols[cur].stop = in.pos[plist[i - 1]];
                st.mols.emplace_back();
                cur = (int32_t)st.mols.size() - 1;
                Molecule& mol = st.mols[cur];
                mol.contig = in.contig[a];
                mol.start = in.pos[a];
                mol.id = molecule_num;
                mol.confidence = 1.0;
                mol.add_aln(in.read_of[a], in.aln_id[a], a);
                ++molecule_num;
            }
            st.mols[cur].add_aln(in.read_of[a], in.aln_id[a], a);
        }
        if (!plist.empty()) st.mols[cur].stop = in.pos[plist.back()];
    }
}

// ------------------------------- markBestAlignmentForReadInMolecule

static void mark_best(State& st) {
    const In& in = st.in;
    Out& out = st.out;
    for (auto& mol : st.mols) {
        OM active_alignments;
        OM best_for_read;
        // snapshot of read keys (list(...iter_keys()))
        vector<int32_t> read_keys(mol.aln_by_read.keys);
        for (int32_t read : read_keys) {
            OM* alns = mol.read_map(read);
            double best_score = NEG_INF;
            int32_t best_aln = -1;
            vector<int32_t> aln_keys(alns->keys);
            for (int32_t aid : aln_keys) {
                int32_t a = alns->get(aid);
                OM* mates = mol.read_map(in.mate_of[read]);
                if (mates != nullptr && mates->size() > 0) {
                    vector<int32_t> mate_keys(mates->keys);
                    for (int32_t mid : mate_keys) {
                        int32_t ma = mates->get(mid);
                        double s = score_alignment(in, out, a, ma, 0.0,
                                                   in.improper);
                        if (s > best_score) {
                            best_score = s;
                            best_aln = a;
                        }
                    }
                } else {
                    if (in.logp[a] > best_score) {
                        best_score = in.logp[a];
                        best_aln = a;
                    }
                }
                if (out.active[a]) active_alignments.set(read, a);
            }
            if (out.active[best_aln]) active_alignments.set(read, best_aln);
            best_for_read.set(read, best_aln);
        }
        for (int32_t a : active_alignments.vals)
            for (int64_t li = in.locs_off[a]; li < in.locs_off[a + 1]; ++li)
                mol.mismatch_locs[in.locs[li]] += 1;
        mol.active = std::move(active_alignments);
        mol.best_for_read = std::move(best_for_read);
    }
}

// ------------------------------------------------------ scrapMolecules

static void scrap(State& st) {
    const In& in = st.in;
    vector<Molecule> kept;
    int32_t count = 0;
    for (auto& mol : st.mols) {
        if (mol.active.size() > 0) {
            for (int32_t read : mol.aln_by_read.keys) {
                OM* amap = mol.read_map(read);
                for (int32_t slot : amap->vals) st.out.mol_id[slot] = count;
            }
            mol.id = count;  // ids renumbered with the compaction
            kept.push_back(std::move(mol));
            ++count;
        } else {
            for (int32_t read : mol.aln_by_read.keys) {
                OM* amap = mol.read_map(read);
                for (int32_t slot : amap->vals) st.out.mol_id[slot] = -1;
            }
        }
    }
    (void)in;
    st.mols = std::move(kept);
}

// NOTE on scrap id semantics: the Python port renumbers molecule_id on the
// ALIGNMENTS but keeps CandidateMolecule.id untouched; downstream the only
// molecule-id consumers are alignment.molecule_id and list positions, and
// fast_score compares source.id != sink.id.  Python ids remain the ORIGINAL
// inference numbering while ours compacts — but identity comparisons
// (source.id != sink.id) only need uniqueness, which both give.  The
// alignment.molecule_id values (compacted) match Python exactly.

static void set_molecule_differences(State& st) {
    const In& in = st.in;
    for (auto& mol : st.mols) {
        double differences = 0.0;
        for (int32_t a : mol.active.vals) differences += in.mismatches[a];
        size_t n_active = mol.active.size();
        mol.differences =
            n_active ? differences / (double)n_active
                     : std::numeric_limits<double>::quiet_NaN();
        for (int32_t a : mol.active.vals) st.out.mol_diff[a] = mol.differences;
    }
}

// ------------------------------------------------------------ optimizer

static bool is_active_molecule(const Molecule& mol, int64_t read_change) {
    int64_t active = (int64_t)mol.active.size() + read_change;
    int64_t potential = (int64_t)mol.best_for_read.size();
    if (active <= 4) return false;
    if ((double)active / (double)potential < 0.1) return false;
    return true;
}

struct Move {
    double score_change = NEG_INF;
    double alignment_change = 0.0;
    int32_t source = -1, sink = -1;
    vector<int32_t> to_delete;
    vector<int32_t> to_set;
    int32_t num_moved = 0;
};

// fastScore (aligner.go:1109-1237)
static double fast_score(State& st, int32_t src_i, int32_t snk_i, Move& mv) {
    const In& in = st.in;
    Molecule& source = st.mols[src_i];
    Molecule& sink = st.mols[snk_i];
    double change = 0.0;
    double alignment_change = 0.0;
    int32_t num = 0;
    mv.to_delete.clear();
    mv.to_set.clear();
    bool diff = src_i != snk_i;

    for (size_t vi = 0; vi < source.active.vals.size(); ++vi) {
        int32_t sa = source.active.vals[vi];
        int32_t read_id = in.read_of[sa];
        int32_t sink_aln = sink.best_for_read.get(read_id);
        if (sink_aln < 0) continue;
        int32_t mate_read = in.mate_of[read_id];
        int32_t source_mate = source.active.get(mate_read);
        bool source_has_mate = source_mate >= 0;
        bool source_has_mate_pair =
            source_has_mate && is_pair(in, sa, source_mate);
        int32_t mate = sink.best_for_read.get(mate_read);
        bool sink_has_mate_pair =
            mate >= 0 && is_pair(in, sink_aln, mate) && source_has_mate;
        if (!source_has_mate_pair || (source_has_mate && sink_has_mate_pair)) {
            mv.to_delete.push_back(read_id);
            mv.to_set.push_back(sink_aln);
        }
        alignment_change += in.logp[sink_aln] - in.logp[sa];
        // consistency check (aligner.go:1159-1184 invariants)
        for (int64_t li = in.locs_off[sa]; li < in.locs_off[sa + 1]; ++li) {
            auto it = source.mismatch_locs.find(in.locs[li]);
            if (it == source.mismatch_locs.end() || it->second == 0)
                return std::numeric_limits<double>::quiet_NaN();  // invariant broken
        }
        if (source_has_mate_pair && !sink_has_mate_pair && diff)
            alignment_change += st.in.improper / 2.0;
        else if (!source_has_mate_pair && sink_has_mate_pair && diff)
            alignment_change -= st.in.improper / 2.0;
        ++num;
    }

    bool source_active_before = is_active_molecule(source, 0);
    bool source_active_after = is_active_molecule(source, -num);
    if (!source_active_after && source_active_before && diff)
        change -= (double)source.best_for_read.size() * -0.5;
    bool sink_active_before = is_active_molecule(sink, 0);
    bool sink_active_after = is_active_molecule(sink, num);
    if (sink_active_after && !sink_active_before && diff)
        change += (double)sink.best_for_read.size() * -0.5;
    if ((int64_t)source.active.size() - num == 0 && num > 0 && diff)
        change -= -3.0;
    if (sink.active.size() == 0 && num > 0 && diff) change += -3.0;
    change += alignment_change;
    mv.source = src_i;
    mv.sink = snk_i;
    mv.num_moved = num;
    mv.score_change = change;
    mv.alignment_change = alignment_change;
    return change;
}

static void accept_move(State& st, Move& mv) {
    const In& in = st.in;
    Molecule& source = st.mols[mv.source];
    Molecule& sink = st.mols[mv.sink];
    for (size_t i = 0; i < mv.to_delete.size(); ++i) {
        int32_t read_id = mv.to_delete[i];
        int32_t sink_aln = mv.to_set[i];
        int32_t source_aln = source.active.get(read_id);
        for (int64_t li = in.locs_off[source_aln];
             li < in.locs_off[source_aln + 1]; ++li)
            source.mismatch_locs[in.locs[li]] -= 1;
        for (int64_t li = in.locs_off[sink_aln]; li < in.locs_off[sink_aln + 1];
             ++li)
            sink.mismatch_locs[in.locs[li]] += 1;
        source.active.del(read_id);
        sink.active.set(read_id, sink_aln);
        st.out.active[source_aln] = 0;
        st.out.active[sink_aln] = 1;
    }
}

// sink_neighborhoods (rfa/optimizer.py:144-167)
static vector<vector<int32_t>> neighborhoods(const State& st) {
    std::unordered_map<int32_t, vector<int32_t>> by_read;
    for (size_t i = 0; i < st.mols.size(); ++i)
        for (int32_t rid : st.mols[i].best_for_read.keys)
            by_read[rid].push_back((int32_t)i);
    vector<vector<char>> nbr_mask(st.mols.size(),
                                  vector<char>(st.mols.size(), 0));
    for (auto& kv : by_read) {
        auto& lst = kv.second;
        if (lst.size() > 1)
            for (int32_t i : lst)
                for (int32_t j : lst) nbr_mask[i][j] = 1;
    }
    vector<vector<int32_t>> out(st.mols.size());
    for (size_t i = 0; i < st.mols.size(); ++i)
        for (size_t j = 0; j < st.mols.size(); ++j)
            if (nbr_mask[i][j] && i != j) out[i].push_back((int32_t)j);
    return out;
}

static void optimize(State& st) {
    if (st.mols.empty()) return;
    auto nbr = neighborhoods(st);
    int32_t current_source = 0;
    int32_t n = (int32_t)st.mols.size();
    int64_t steps_per_temp = (int64_t)st.in.anneal_factor * n;
    Move best, cand;
    for (int32_t t = 0; t < st.in.temp_steps; ++t) {
        for (int64_t s = 0; s < steps_per_temp; ++s) {
            Molecule& source = st.mols[current_source];
            if (source.active.size() == 0) {
                current_source = (current_source + 1) % n;
                continue;
            }
            best = Move();
            best.sink = current_source;  // sentinel mirror of best.sink=source
            bool best_valid = false;
            for (int32_t i : nbr[current_source]) {
                double score = fast_score(st, current_source, i, cand);
                bool better =
                    score > best.score_change ||
                    (score == best.score_change && best.sink >= 0 &&
                     cand.sink >= 0 &&
                     st.mols[cand.sink].active.size() >
                         st.mols[best.sink].active.size());
                if (better && cand.num_moved > 0) {
                    best = cand;
                    best_valid = true;
                }
            }
            if (best_valid && best.num_moved > 0) {
                if (best.score_change > 0 ||
                    (best.score_change == 0 &&
                     st.mols[best.sink].active.size() >
                         source.active.size()))
                    accept_move(st, best);
            }
            current_source = (current_source + 1) % n;
        }
    }
}

// --------------------------------------------- estimateMapQualities

static void molecule_mapq_probability_sums(State& st) {
    if (st.mols.empty()) return;
    const In& in = st.in;
    auto nbr = neighborhoods(st);
    Move scratch;
    vector<int32_t> source_alignments;
    for (size_t mol_id = 0; mol_id < st.mols.size(); ++mol_id) {
        Molecule& source = st.mols[mol_id];
        for (int32_t mol2 : nbr[mol_id]) {
            Molecule& sink = st.mols[mol2];
            source_alignments.clear();
            for (int32_t a : source.active.vals)
                if (sink.best_for_read.get(in.read_of[a]) >= 0)
                    source_alignments.push_back(a);
            if (source_alignments.empty()) continue;
            double change =
                fast_score(st, (int32_t)mol_id, mol2, scratch);
            double move_probability = std::pow(10.0, change);
            for (int32_t a : source_alignments)
                st.out.sum_move[a] += move_probability;
        }
    }
}

static void set_molecule_confidences(State& st) {
    for (auto& mol : st.mols) {
        mol.confidence =
            (double)mol.active.size() / (double)mol.best_for_read.size();
        for (int32_t a : mol.active.vals) {
            if (st.in.soft_clipped[a] > 0) mol.soft_clipped += 1;
            st.out.mol_conf[a] = mol.confidence;
        }
    }
}

static void update_molecule_status(
    State& st, std::unordered_map<int32_t, int32_t>& in_active,
    std::unordered_map<int32_t, int32_t>& not_in_active,
    std::unordered_map<int32_t, std::unordered_map<int32_t, char>>& uniq) {
    // (molecules always present when called on the RFA path)
    set_molecule_confidences(st);
    set_molecule_differences(st);
    const In& in = st.in;
    for (int32_t r = 0; r < in.R; ++r) {
        for (int64_t a = st.rbeg(r); a < st.rend(r); ++a) {
            bool is_active = false;
            int32_t mid = st.out.mol_id[a];
            if (mid != -1) {
                Molecule& mol = st.mols[mid];
                is_active = (int64_t)mol.active.size() - mol.soft_clipped > 4 &&
                            mol.confidence > 0.1;
                st.out.active_mol[a] = is_active ? 1 : 0;
            }
            if (is_active) {
                st.mols[mid].active_molecule = true;
                in_active[r] += 1;
                uniq[r][mid] = 1;
            } else {
                not_in_active[r] += 1;
            }
            if (mid != -1)
                st.out.reads_in_mol[a] = (int32_t)st.mols[mid].active.size();
        }
    }
}

static double calculate_log_molecule_penalty(State& st) {
    double dna_length = 1000.0;
    if (st.mols.empty()) return 0.0;
    const In& in = st.in;
    for (auto& mol : st.mols) {
        if (mol.active_molecule) {
            double smallest = POS_INF;
            double biggest = -1.0;
            for (int32_t a : mol.active.vals) {
                biggest = std::max(biggest, (double)in.pos[a]);
                smallest = std::min(smallest, (double)in.pos[a]);
            }
            if (biggest >= smallest) dna_length += (biggest - smallest) + 1000.0;
        } else {
            for (int32_t a : mol.active.vals)
                dna_length += (double)(in.aend[a] - in.pos[a]) * 2.0;
        }
    }
    double singleton_prob = 0.05;
    return std::log10(dna_length / st.in.ref_len * singleton_prob);
}

static int estimate_map_qualities(State& st, bool have_molecules) {
    const In& in = st.in;
    Out& out = st.out;
    std::unordered_map<int32_t, int32_t> in_active, not_in_active;
    std::unordered_map<int32_t, std::unordered_map<int32_t, char>> uniq;

    if (have_molecules) {
        molecule_mapq_probability_sums(st);
        update_molecule_status(st, in_active, not_in_active, uniq);
    }
    double mol_pen = calculate_log_molecule_penalty(st);

    vector<double> scores;
    for (int32_t r = 0; r < in.R; ++r) {
        scores.clear();
        int64_t b = st.rbeg(r), e = st.rend(r);
        int32_t mate_read = in.mate_of[r];
        int64_t mb = st.rbeg(mate_read), me = st.rend(mate_read);
        // _append_pseudocount_score
        if (e > b) {
            double best_single_mate = NEG_INF;
            for (int64_t ma = mb; ma < me; ++ma) {
                double s = score_alignment(in, out, -1, (int32_t)ma, mol_pen,
                                           in.improper);
                if (s > best_single_mate) best_single_mate = s;
            }
            if (me > mb)
                scores.push_back(best_single_mate +
                                 pseudo_count_score(in, (int32_t)b, mol_pen));
            else
                scores.push_back(pseudo_count_score(in, (int32_t)b, mol_pen));
        }
        double total_probability = 0.0;
        // link active mates
        for (int64_t a = b; a < e; ++a)
            for (int64_t ma = mb; ma < me; ++ma)
                if (out.active[a] && out.active[ma]) {
                    out.mate_slot[a] = (int32_t)ma;
                    out.mate_slot[ma] = (int32_t)a;
                }
        for (int64_t a = b; a < e; ++a) {
            double best_score = NEG_INF;
            for (int64_t ma = mb; ma < me; ++ma) {
                double s = score_alignment(in, out, (int32_t)a, (int32_t)ma,
                                           mol_pen, in.improper);
                if (s > best_score) best_score = s;
            }
            if (me == mb)
                best_score =
                    score_alignment(in, out, (int32_t)a, -1, mol_pen, in.improper);
            scores.push_back(best_score);
        }
        // second-best bookkeeping
        bool sb_proper = false;
        double sb_raw = scores.empty() ? 0.0 : scores[0];
        double sb_logp = -1000.0;
        int32_t sb_mol_reads = -1;
        int32_t sb_slot = -1;
        double sb_mol_conf = -1.0;
        for (int64_t a = b; a < e; ++a) {
            for (int64_t ma = mb; ma < me; ++ma) {
                double s = score_alignment(in, out, (int32_t)a, (int32_t)ma,
                                           mol_pen, in.improper);
                if (!out.active[a] && s > sb_logp) {
                    sb_logp = s;
                    sb_raw = score_alignment(in, out, (int32_t)a, (int32_t)ma,
                                             0.0, in.improper);
                    sb_slot = (int32_t)a;
                    out.mate_slot[a] = (int32_t)ma;
                    sb_proper = out.proper[a] != 0;
                    if (out.mol_id[a] != -1 && have_molecules) {
                        Molecule& alt = st.mols[out.mol_id[a]];
                        sb_mol_conf = alt.confidence;
                        sb_mol_reads = (int32_t)alt.active.size();
                    }
                }
            }
        }
        for (int64_t a = b; a < e; ++a) {
            if (out.active[a]) {
                out.sb_slot[a] = sb_slot;
                out.sb_score[a] = sb_raw;
                out.sb_proper[a] = sb_proper ? 1 : 0;
                out.sb_mol_conf[a] = sb_mol_conf;
                out.sb_mol_reads[a] = sb_mol_reads;
                out.copies[a] = (int32_t)(e - b);
                auto it1 = in_active.find(r);
                out.copies_in[a] = it1 == in_active.end() ? 0 : it1->second;
                auto it2 = not_in_active.find(r);
                out.copies_out[a] = it2 == not_in_active.end() ? 0 : it2->second;
                auto it3 = uniq.find(r);
                out.uniq_mols[a] = it3 == uniq.end() ? 0 : (int32_t)it3->second.size();
                out.md_score[a] = score_alignment(in, out, (int32_t)a,
                                                  out.mate_slot[a], 0.0,
                                                  in.improper);
            }
        }
        // top-15 normalization
        std::sort(scores.begin(), scores.end());
        for (int64_t i = (int64_t)scores.size() - 1; i >= 0; --i) {
            if ((int64_t)scores.size() - i > 15) break;
            total_probability += std::pow(10.0, scores[i]);
        }
        // final mapq
        for (int64_t a = b; a < e; ++a) {
            double s = score_alignment(in, out, (int32_t)a, out.mate_slot[a],
                                       mol_pen, in.improper);
            double ratio = total_probability > 0.0
                               ? std::pow(10.0, s) / total_probability
                               : 1.0;
            double mapq =
                ratio < 1.0 ? -10.0 * std::log10(1.0 - ratio) : POS_INF;
            double molecule_mapq;
            if (out.sum_move[a] > 0.0) {
                double inv = 1.0 / out.sum_move[a];
                molecule_mapq =
                    inv < 1.0 ? -10.0 * std::log10(1.0 - inv) : POS_INF;
            } else {
                molecule_mapq = POS_INF;
            }
            mapq = std::min(mapq, molecule_mapq);
            mapq = std::min(60.0, mapq);
            int64_t cs = in.cen_start[in.contig[a]];
            int64_t ce = in.cen_end[in.contig[a]];
            if (cs < in.pos[a] && in.pos[a] <= ce) mapq = 0.0;
            out.mapq[a] = (int32_t)mapq;
        }
    }
    // checkMates invariant
    for (int32_t a = 0; a < in.A; ++a)
        if (out.active[a] && out.mate_slot[a] >= 0 &&
            !out.active[out.mate_slot[a]])
            return -2;
    return 0;
}


// One barcode's tail: tagBestAlignments, then with run_rfa the molecules,
// the optimizer and the molecule-aware MAPQ, else the MAPQ alone.
static int run_tail(const In& in, Out& out) {
    State st(in, out);
    vector<vector<int32_t>> positions;
    tag_best(st, positions);
    int rc;
    if (in.run_rfa) {
        infer_molecules(st, positions);
        mark_best(st);
        scrap(st);
        set_molecule_differences(st);
        optimize(st);
        rc = estimate_map_qualities(st, true);
        *out.n_molecules = (int32_t)st.mols.size();
    } else {
        rc = estimate_map_qualities(st, false);
        *out.n_molecules = 0;
    }
    return rc;
}

// ------------------------------------------------------------ the superbatch

// The output rows of rfa_superbatch, a column a hit: rfa/batch.py reads
// them by these numbers.
enum I32Row {
    MATCHES, MISMATCHES, INDELS, SOFT_CLIPPED, SOFT_LEN, N_LOCS, KEPT,
    ACTIVE, PROPER, BWA_PICK, MAPQ, MOL_ID, ACTIVE_MOL, MATE, SECOND_BEST,
    SB_PROPER, SB_MOL_READS, COPIES, COPIES_IN, COPIES_OUT, UNIQ_MOLS,
    READS_IN_MOL, N_I32
};
enum F64Row {
    LOGP, UPDATED_LOGP, MOL_CONF, MOL_DIFF, SUM_MOVE, SB_SCORE, SB_MOL_CONF,
    MD_SCORE, N_F64
};

struct Batch {
    const int64_t* bc_read_off;   // (n_bc+1) into the reads
    const int64_t* read_hit_off;  // (n_reads+1) into the hits
    const uint8_t* run_rfa;       // (n_bc)
    const uint8_t* codes;         // the reads' codes, as sequenced
    const int64_t* code_off;      // (n_reads+1)
    const uint64_t* jitter;       // (n_reads) md5 seeds of the read names
    const int64_t* ch_pos;        // the chain's contig coordinates (H)
    const int64_t* ch_aend;
    const int32_t* ch_score;
    const int32_t* hit_id;
    const int32_t* mate_id;
    const int32_t* cig;           // (op, len) pairs
    const int64_t* cig_off;       // (H+1), pairs
    const int64_t* nm;            // reg2aln's NM, -1 for none
    const int64_t* rid;           // reg2aln's contig, -1 for none
    const uint8_t* is_rev;
    const uint8_t* fwd;           // forward codes, or null: read the 2-bit pac
    const uint8_t* pac;
    int64_t l_pac;
    const int64_t* contig_off;    // (n_contigs)
    const int64_t* contig_len;
    int64_t n_contigs;
    const int64_t* cen_start;     // (n_contigs+1) by rid + 1, -1 = none
    const int64_t* cen_end;
    double improper, ref_len;
    int32_t delta, temp_steps, anneal_factor;
    int64_t H;
    const int64_t* loc_cap;       // (H) where hit h's loci start, before compaction
    int64_t* coords;              // (2, H) pos, aend
    int32_t* i32;                 // (N_I32, H)
    double* f64;                  // (N_F64, H)
    int64_t* locs;
    int32_t* rlocs;
    int32_t* n_mol;               // (n_bc)
    int32_t* rc;                  // (n_bc)
};

inline uint8_t pac_base(const uint8_t* pac, int64_t p) {
    return (pac[p >> 2] >> ((~p & 3) << 1)) & 3;
}

// The reference window [beg, end) as fetch_seq_batch gives it -- clamped
// to the contig that holds its middle, on that strand -- then oriented as
// the read: reverse-complemented for a reversed hit.
static void fetch_window(const Batch& B, int64_t beg, int64_t end, bool rev,
                         vector<uint8_t>& out) {
    out.clear();
    const int64_t mid = (beg + end) >> 1;
    if (end < beg) std::swap(beg, end);
    const int64_t two = B.l_pac << 1;
    if (mid < 0 || mid >= two) return;
    const bool mid_rev = mid >= B.l_pac;
    const int64_t fmid = mid_rev ? two - 1 - mid : mid;
    const int64_t r =
        std::upper_bound(B.contig_off, B.contig_off + B.n_contigs, fmid) - B.contig_off - 1;
    if (r < 0) return;
    int64_t far_beg = B.contig_off[r], far_end = far_beg + B.contig_len[r];
    if (mid_rev) {
        const int64_t fb = two - far_end;
        far_end = two - far_beg;
        far_beg = fb;
    }
    beg = std::max(beg, far_beg);
    end = std::min(end, far_end);
    if (end <= beg) return;
    const int64_t n = end - beg;
    const bool strand_rev = beg >= B.l_pac;
    out.resize((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t p = strand_rev ? two - 1 - (beg + i) : beg + i;
        const uint8_t c = B.fwd ? B.fwd[p] : pac_base(B.pac, p);
        const uint8_t s = strand_rev ? (uint8_t)(3 - c) : c;
        if (rev)
            out[(size_t)(n - 1 - i)] = (uint8_t)(3 - s);
        else
            out[(size_t)i] = s;
    }
}

// GetAlignments' walk of one hit (aligner.go:1511-1631): the final
// coordinates, the M-segment mismatch loci (reference and read), the
// indel and soft-clip counters -- reversed hits walk the CIGAR back to
// front -- and the log probabilities of rfa/candidates.py, in its order
// of float operations.
__attribute__((optimize("fp-contract=off")))
static void walk_hit(const Batch& B, int64_t h, const uint8_t* read, int64_t read_len,
                     vector<uint8_t>& ref) {
    const int64_t H = B.H;
    const bool rev = B.is_rev[h] != 0;
    const int64_t pos = B.ch_pos[h], aend = B.ch_aend[h];
    const bool swap = pos != -1 && rev;
    B.coords[h] = swap ? aend + 1 : pos;
    B.coords[H + h] = swap ? pos + 1 : aend;
    const int64_t rstart = rev ? aend + 1 : pos, rend = rev ? pos + 1 : aend;
    const int64_t c0 = B.cig_off[h], c1 = B.cig_off[h + 1];
    ref.clear();
    if (c1 > c0) {
        const int64_t off = B.rid[h] >= 0 ? B.contig_off[B.rid[h]] : 0;
        fetch_window(B, rstart + off, rend + off, rev, ref);
    }
    const int64_t ref_len = (int64_t)ref.size();
    int64_t* locs = B.locs + B.loc_cap[h];
    int32_t* rlocs = B.rlocs + B.loc_cap[h];
    int64_t matches = 0, indels = 0, indel_len = 0, sc = 0, sc_len = 0;
    int64_t ref_o = 0, read_o = 0;
    int32_t n_locs = 0;
    for (int64_t step = 0; step < c1 - c0; ++step) {
        const int64_t k = rev ? (c1 - 1 - step) : (c0 + step);
        const int32_t op = B.cig[2 * k], ln = B.cig[2 * k + 1];
        if (op == 0) {
            matches += ln;
            int64_t limit = std::min<int64_t>(ln, std::min(ref_len - ref_o, read_len - read_o));
            for (int64_t m = 0; m < limit; ++m) {
                if (ref[(size_t)(ref_o + m)] != read[read_o + m]) {
                    locs[n_locs] = rev ? (rend - (ref_o + m)) : (ref_o + rstart + m);
                    rlocs[n_locs] = (int32_t)(read_o + m);
                    ++n_locs;
                }
            }
            ref_o += ln;
            read_o += ln;
        } else if (op == 1) {
            indels += 1;
            indel_len += ln;
            read_o += ln;
        } else if (op == 2) {
            indels += 1;
            indel_len += ln;
            ref_o += ln;
        } else if (op == 3) {
            sc += 1;
            sc_len += ln;
            read_o += ln;
        }
    }
    int64_t mismatches = (B.nm[h] >= 0 ? B.nm[h] : 0) - indel_len;
    matches -= mismatches;
    if (mismatches < 0) mismatches = 0;
    int32_t* I = B.i32;
    I[MATCHES * H + h] = (int32_t)matches;
    I[MISMATCHES * H + h] = (int32_t)mismatches;
    I[INDELS * H + h] = (int32_t)indels;
    I[SOFT_CLIPPED * H + h] = (int32_t)sc;
    I[SOFT_LEN * H + h] = (int32_t)sc_len;
    I[N_LOCS * H + h] = n_locs;
    // score_alignment(aln, None, 0.0, improper) - improper, and the
    // updated probability with its 2.0 a mismatch locus
    double s = 0.0;
    s += (double)mismatches * -2.0 + (double)indels * -3.0;
    if (sc > 0) {
        s -= 5.0 * (double)sc;
        s -= (double)sc_len * 0.5;
    }
    s += B.improper;
    s += 0.0;
    const double logp = s - B.improper;
    B.f64[LOGP * H + h] = logp;
    B.f64[UPDATED_LOGP * H + h] = logp + 2.0 * (double)n_locs;
}

// per-thread buffers, reused from barcode to barcode
struct Scratch {
    vector<uint8_t> window;
    vector<int32_t> kept;
    vector<int64_t> aln_off, pos, aend, locs, locs_off;
    vector<int32_t> mate_of, mism, indels, sclip, slen, seqlen, contig, aln_id, read_of;
    vector<double> logp, score;
    vector<uint8_t> rev;
    vector<uint8_t> o_active, o_proper, o_pick, o_amol, o_sbp;
    vector<int32_t> o_mapq, o_molid, o_mate, o_sb, o_sbr, o_cp, o_cpi, o_cpo, o_uniq, o_rim;
    vector<double> o_mconf, o_mdiff, o_sum, o_sbs, o_sbc, o_mds;
};

template <class T>
static T* fill(vector<T>& v, size_t n, T value) {
    v.assign(n, value);
    return v.data();
}

static void run_barcode(const Batch& B, int64_t b, Scratch& s) {
    const int64_t H = B.H;
    int32_t* I = B.i32;
    double* F = B.f64;
    const int64_t r0 = B.bc_read_off[b], r1 = B.bc_read_off[b + 1];
    const int64_t R = r1 - r0;
    // the walk, and the best-17 filter against each read's best chain score
    // (aligner.go:1586-1629)
    for (int64_t r = r0; r < r1; ++r) {
        const uint8_t* read = B.codes + B.code_off[r];
        const int64_t read_len = B.code_off[r + 1] - B.code_off[r];
        int32_t best = 0;
        for (int64_t h = B.read_hit_off[r]; h < B.read_hit_off[r + 1]; ++h) {
            walk_hit(B, h, read, read_len, s.window);
            if (B.ch_score[h] > best) best = B.ch_score[h];
        }
        for (int64_t h = B.read_hit_off[r]; h < B.read_hit_off[r + 1]; ++h)
            I[KEPT * H + h] = B.ch_score[h] >= best - B.delta ? 1 : 0;
    }
    // the kept hits enter the tail, read by read
    s.kept.clear();
    s.aln_off.assign((size_t)R + 1, 0);
    s.mate_of.assign((size_t)R, 0);
    for (int64_t r = 0; r < R; ++r) {
        s.aln_off[r] = (int64_t)s.kept.size();
        for (int64_t h = B.read_hit_off[r0 + r]; h < B.read_hit_off[r0 + r + 1]; ++h)
            if (I[KEPT * H + h]) s.kept.push_back((int32_t)h);
        s.mate_of[r] = (int64_t)s.kept.size() > s.aln_off[r] ? B.mate_id[s.kept[s.aln_off[r]]]
                                                              : (int32_t)(r ^ 1);
    }
    s.aln_off[R] = (int64_t)s.kept.size();
    const size_t A = s.kept.size();
    s.pos.resize(A); s.aend.resize(A); s.logp.resize(A); s.score.resize(A);
    s.mism.resize(A); s.indels.resize(A); s.sclip.resize(A); s.slen.resize(A);
    s.seqlen.resize(A); s.rev.resize(A); s.contig.resize(A); s.aln_id.resize(A);
    s.read_of.resize(A); s.locs_off.assign(A + 1, 0); s.locs.clear();
    for (size_t a = 0; a < A; ++a) {
        const int64_t h = s.kept[a];
        s.pos[a] = B.coords[h];
        s.aend[a] = B.coords[H + h];
        s.logp[a] = F[LOGP * H + h];
        s.score[a] = (double)B.ch_score[h];
        s.mism[a] = I[MISMATCHES * H + h];
        s.indels[a] = I[INDELS * H + h];
        s.sclip[a] = I[SOFT_CLIPPED * H + h];
        s.slen[a] = I[SOFT_LEN * H + h];
        s.rev[a] = B.is_rev[h];
        s.contig[a] = (int32_t)(B.rid[h] + 1);
        s.aln_id[a] = B.hit_id[h];
        s.locs.insert(s.locs.end(), B.locs + B.loc_cap[h],
                      B.locs + B.loc_cap[h] + I[N_LOCS * H + h]);
        s.locs_off[a + 1] = (int64_t)s.locs.size();
    }
    for (int64_t r = 0; r < R; ++r) {
        const int64_t len = B.code_off[r0 + r + 1] - B.code_off[r0 + r];
        for (int64_t a = s.aln_off[r]; a < s.aln_off[r + 1]; ++a) {
            s.seqlen[a] = (int32_t)len;
            s.read_of[a] = (int32_t)r;
        }
    }
    if (s.locs.empty()) s.locs.push_back(0);
    In in{(int32_t)R, (int32_t)A, s.pos.data(), s.aend.data(), s.logp.data(),
          s.score.data(), s.mism.data(), s.indels.data(), s.sclip.data(),
          s.slen.data(), s.seqlen.data(), s.rev.data(), s.contig.data(),
          s.aln_id.data(), s.read_of.data(), s.locs.data(), s.locs_off.data(),
          s.aln_off.data(), s.mate_of.data(), B.jitter + r0, B.improper,
          B.ref_len, B.run_rfa[b], B.temp_steps, B.anneal_factor,
          B.cen_start, B.cen_end};
    const double conf0 = 0.00075 * 0.025;   // Alignment.molecule_confidence's default
    Out out{fill<uint8_t>(s.o_active, A, 0), fill<uint8_t>(s.o_proper, A, 0),
            fill<uint8_t>(s.o_pick, A, 0), fill<int32_t>(s.o_mapq, A, 0),
            fill<int32_t>(s.o_molid, A, -1), fill<uint8_t>(s.o_amol, A, 0),
            fill<double>(s.o_mconf, A, conf0), fill<double>(s.o_mdiff, A, 0.0),
            fill<double>(s.o_sum, A, 1.0), fill<int32_t>(s.o_mate, A, -1),
            fill<int32_t>(s.o_sb, A, -1), fill<double>(s.o_sbs, A, 0.0),
            fill<uint8_t>(s.o_sbp, A, 0), fill<int32_t>(s.o_sbr, A, 0),
            fill<double>(s.o_sbc, A, 0.0), fill<int32_t>(s.o_cp, A, 0),
            fill<int32_t>(s.o_cpi, A, 0), fill<int32_t>(s.o_cpo, A, 0),
            fill<int32_t>(s.o_uniq, A, 0), fill<double>(s.o_mds, A, 0.0),
            fill<int32_t>(s.o_rim, A, 0), B.n_mol + b};
    B.rc[b] = run_tail(in, out);
    // every hit of the barcode: a default Alignment's values, then the
    // tail's for the kept ones, slots turned into hit numbers
    const int64_t h0 = B.read_hit_off[r0], h1 = B.read_hit_off[r1];
    for (int row = ACTIVE; row < N_I32; ++row)
        std::fill(I + row * H + h0, I + row * H + h1,
                  row == MOL_ID || row == MATE || row == SECOND_BEST ? -1 : 0);
    std::fill(F + MOL_CONF * H + h0, F + MOL_CONF * H + h1, conf0);
    std::fill(F + SUM_MOVE * H + h0, F + SUM_MOVE * H + h1, 1.0);
    for (int row : {MOL_DIFF, SB_SCORE, SB_MOL_CONF, MD_SCORE})
        std::fill(F + row * H + h0, F + row * H + h1, 0.0);
    for (size_t a = 0; a < A; ++a) {
        const int64_t h = s.kept[a];
        I[ACTIVE * H + h] = s.o_active[a];
        I[PROPER * H + h] = s.o_proper[a];
        I[BWA_PICK * H + h] = s.o_pick[a];
        I[MAPQ * H + h] = s.o_mapq[a];
        I[MOL_ID * H + h] = s.o_molid[a];
        I[ACTIVE_MOL * H + h] = s.o_amol[a];
        I[MATE * H + h] = s.o_mate[a] >= 0 ? s.kept[s.o_mate[a]] : -1;
        I[SECOND_BEST * H + h] = s.o_sb[a] >= 0 ? s.kept[s.o_sb[a]] : -1;
        I[SB_PROPER * H + h] = s.o_sbp[a];
        I[SB_MOL_READS * H + h] = s.o_sbr[a];
        I[COPIES * H + h] = s.o_cp[a];
        I[COPIES_IN * H + h] = s.o_cpi[a];
        I[COPIES_OUT * H + h] = s.o_cpo[a];
        I[UNIQ_MOLS * H + h] = s.o_uniq[a];
        I[READS_IN_MOL * H + h] = s.o_rim[a];
        F[MOL_CONF * H + h] = s.o_mconf[a];
        F[MOL_DIFF * H + h] = s.o_mdiff[a];
        F[SUM_MOVE * H + h] = s.o_sum[a];
        F[SB_SCORE * H + h] = s.o_sbs[a];
        F[SB_MOL_CONF * H + h] = s.o_sbc[a];
        F[MD_SCORE * H + h] = s.o_mds[a];
    }
}

}  // namespace

// RFA's host stage for a superbatch: every hit of every barcode walked
// against its reference window and filtered, then each barcode's tail.
// Barcodes are independent and spread over n_threads.  The mismatch loci
// come back compacted, hit h's at [loc_off[h], loc_off[h + 1]); rc[b] is
// the tail's return code (-2: an active alignment with an inactive mate).
extern "C" int rfa_superbatch(
    int64_t n_bc, const int64_t* bc_read_off, const int64_t* read_hit_off,
    const uint8_t* run_rfa, const uint8_t* codes, const int64_t* code_off,
    const uint64_t* jitter, int64_t H, const int64_t* ch_pos, const int64_t* ch_aend,
    const int32_t* ch_score, const int32_t* hit_id, const int32_t* mate_id,
    const int32_t* cig, const int64_t* cig_off, const int64_t* nm, const int64_t* rid,
    const uint8_t* is_rev, const uint8_t* fwd, const uint8_t* pac, int64_t l_pac,
    const int64_t* contig_off, const int64_t* contig_len, int64_t n_contigs,
    const int64_t* cen_start, const int64_t* cen_end, double improper, double ref_len,
    int32_t delta, int32_t temp_steps, int32_t anneal_factor, const int64_t* loc_cap,
    int64_t* coords, int32_t* i32, double* f64, int64_t* locs, int32_t* rlocs,
    int64_t* loc_off, int32_t* n_mol, int32_t* rc, int32_t n_threads) {
    const Batch B{bc_read_off, read_hit_off, run_rfa, codes, code_off, jitter, ch_pos,
                  ch_aend, ch_score, hit_id, mate_id, cig, cig_off, nm, rid, is_rev, fwd,
                  pac, l_pac, contig_off, contig_len, n_contigs, cen_start, cen_end,
                  improper, ref_len, delta, temp_steps, anneal_factor, H, loc_cap,
                  coords, i32, f64, locs, rlocs, n_mol, rc};
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        Scratch s;
        for (int64_t b; (b = next.fetch_add(1)) < n_bc;) run_barcode(B, b, s);
    };
    int64_t nt = std::min<int64_t>(std::min<int64_t>(n_threads, 16), n_bc);
    if (H < 256) nt = 1;
    if (nt <= 1) {
        work();
    } else {
        vector<std::thread> threads;
        for (int64_t t = 0; t < nt; ++t) threads.emplace_back(work);
        for (auto& th : threads) th.join();
    }
    loc_off[0] = 0;
    for (int64_t h = 0; h < H; ++h) {
        const int64_t n = i32[N_LOCS * H + h], from = loc_cap[h], to = loc_off[h];
        if (to != from && n > 0) {
            std::memmove(locs + to, locs + from, (size_t)n * sizeof(int64_t));
            std::memmove(rlocs + to, rlocs + from, (size_t)n * sizeof(int32_t));
        }
        loc_off[h + 1] = to + n;
    }
    return 0;
}
